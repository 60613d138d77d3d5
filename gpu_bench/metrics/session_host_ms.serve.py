"""Host ms per chunk of the session's own work in ``ask_batch``:
collation and padding, the copy to the device, the top-k decode (the
harness's spans around ``_collate_chunk``, ``_to_device`` and ``_decode``
over the untraced stretch of the traced run). The forward's launches and
the wait for its results are not in it."""


def read(ctx, outcome):
    host = outcome["host"]
    chunks = host["calls"].get("collate", 0)
    if not chunks:
        return None
    spent = sum(host["seconds"].get(k, 0.0)
                for k in ("collate", "copy", "decode"))
    return 1e3 * spent / chunks
