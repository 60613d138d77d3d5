"""Serve a trained VQA checkpoint over HTTP (the counterpart of the
repo-root ``serve_vqa.py``):

    python -m t5_resnet_vqa_torch.serve --config config.json --port 8000 \
        [--batch-size 64] [--set trainer_kwargs.output_dir=/path/to/run]

    curl -s localhost:8000/healthz
    curl -s -X POST localhost:8000/v1/ask -d \
        '{"image_path": "/data/images/image3.png", \
          "question": "what is on the table?", "top_k": 3}'

Restores ``best-model.pt`` and the answer space of ``model_ckpt_info.json``
(``VQAInferenceSession.from_checkpoint``) and serves /healthz, /v1/ask,
/v1/ask_batch and, for the ViT encoder-decoder family, /v1/generate (the
protocol: ``eval/http_server.py``). It runs on the card unless
``--set trainer_kwargs.device=cpu`` names the CPU. One device only:
``--data-parallel`` and ``--model-parallel`` other than 1 raise.
"""

import argparse

from .core.config import Config
from .eval.http_server import VQAHTTPServer
from .eval.session import VQAInferenceSession


def build_server(argv=None) -> VQAHTTPServer:
    """Parse the arguments, restore the session and bind the server."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="vit_daquar_config.json",
                   help="six-group JSON config (reference layout accepted)")
    p.add_argument("--set", action="append", default=[], metavar="GROUP.KEY=V",
                   help="config override, e.g. trainer.output_dir=/run")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch-size", type=int, default=64,
                   help="the session's fixed batch")
    p.add_argument("--top-k", type=int, default=1,
                   help="default top_k when a request omits it")
    p.add_argument("--image-root", default=None,
                   help="allowlist root for request image_path values; "
                        "required for image_path on non-loopback --host "
                        "(remote clients may always send image_b64)")
    p.add_argument("--data-parallel", type=int, default=1, metavar="DP",
                   help="data-axis size of a mesh (not ported: must be 1)")
    p.add_argument("--model-parallel", type=int, default=1, metavar="TP",
                   help="model-axis size of a mesh (not ported: must be 1)")
    args = p.parse_args(argv)
    if args.data_parallel != 1 or args.model_parallel != 1:
        raise NotImplementedError(
            "the port serves on one device; a mesh comes with ROADMAP.md, "
            "modules item 11")

    cfg = Config.from_json(args.config, overrides=args.set)
    session = VQAInferenceSession.from_checkpoint(cfg,
                                                  batch_size=args.batch_size)
    server = VQAHTTPServer(session, host=args.host, port=args.port,
                           default_top_k=args.top_k, logger=print,
                           image_root=args.image_root)
    print(f"serving {session.family} family "
          f"({len(session.answer_spaces)}-answer space) "
          f"on http://{server.host}:{server.port} "
          f"(batch {session.batch_size})", flush=True)
    return server


def main(argv=None) -> None:
    server = build_server(argv)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()


if __name__ == "__main__":
    main()
