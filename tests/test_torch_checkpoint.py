"""The port's ``CheckpointManager`` through the crash windows of the JAX
package's checkpoint tests (``tests/test_trainer.py``), one case each.

Each case builds the state a kill leaves on disk (or kills a save through
a failing write), opens the directory with a fresh manager, as a resumed
run does, and checks what it reads: a complete ``.next`` is adopted, a lone
params ``.next`` is thrown away, a live pair writer is left alone, a save
that dies keeps the previous pair. The background cases hold the writer at
a gate to check superseding, the count bound and the byte budget, and that
a background save writes the tree as it was when submitted, though the
caller changes it in place afterwards (as the optimizer does). The last
case holds the directory's guard in a second process.
"""

import fcntl
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from t5_resnet_vqa_torch.core.logging import Logger
from t5_resnet_vqa_torch.train.callbacks import CheckpointManager, EarlyStopping

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_S = 30          # a held writer waits at most this long


def _tree(v):
    return {"w": torch.full((2,), float(v))}


def _save_pair_vals(cm, pval, sval):
    cm.save_pair(_tree(pval), {"epoch": int(sval), **_tree(sval)})


def _val(cm, name):
    return float(cm.restore_tree(name)["w"][0])


def _pair_vals(cm):
    return _val(cm, "checkpoint-model"), _val(cm, "state_dict_checkpoint")


def _debris(cm):
    return sorted(p for p in os.listdir(cm.output_dir)
                  if p.endswith((".next", ".tmp", ".old")))


def _write_next(cm, name, tree):
    """The state a kill leaves after ``name``'s ``.next`` landed."""
    cm._save_file(cm._path(name) + ".next", tree)


def _gated(cm):
    """Hold every file write of ``cm`` until the returned event is set;
    returns (gate, the values written, in order)."""
    gate = threading.Event()
    written = []
    real = cm._save_file

    def slow(path, tree):
        assert gate.wait(GATE_S), "the gate never opened"
        if "w" in tree:
            written.append(float(tree["w"][0]))
        real(path, tree)

    cm._save_file = slow
    return gate, written


def lone_next_adopted(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    cm.save_tree("best-model", _tree(1.0))
    _write_next(cm, "best-model", _tree(2.0))
    fresh = CheckpointManager(str(tmp_path))
    assert fresh.exists("best-model")
    assert _val(fresh, "best-model") == 2.0
    assert _debris(fresh) == []


def interrupted_swap_finished(tmp_path):
    # killed between the params move and the state move
    cm = CheckpointManager(str(tmp_path))
    _save_pair_vals(cm, 1.0, 1.0)
    cm.save_tree("checkpoint-model", _tree(2.0))
    _write_next(cm, "state_dict_checkpoint", {"epoch": 2, **_tree(2.0)})
    assert _pair_vals(CheckpointManager(str(tmp_path))) == (2.0, 2.0)


def lone_params_next_discarded(tmp_path):
    # killed after the params .next landed, before the state .next did
    cm = CheckpointManager(str(tmp_path))
    _save_pair_vals(cm, 1.0, 1.0)
    _write_next(cm, "checkpoint-model", _tree(2.0))
    fresh = CheckpointManager(str(tmp_path))
    assert fresh.exists("checkpoint-model")
    assert _pair_vals(fresh) == (1.0, 1.0)
    assert _debris(fresh) == []


def both_nexts_adopted(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    _save_pair_vals(cm, 1.0, 1.0)
    _write_next(cm, "checkpoint-model", _tree(2.0))
    _write_next(cm, "state_dict_checkpoint", {"epoch": 2, **_tree(2.0)})
    assert _pair_vals(CheckpointManager(str(tmp_path))) == (2.0, 2.0)


def live_writer_skipped(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    _save_pair_vals(cm, 1.0, 1.0)
    _write_next(cm, "checkpoint-model", _tree(2.0))
    # a live writer holds pair.lock (flock conflicts across fds as across
    # processes)
    fd = os.open(cm._pair_lock_path(), os.O_CREAT | os.O_RDWR, 0o644)
    fcntl.flock(fd, fcntl.LOCK_EX)
    try:
        reader = CheckpointManager(str(tmp_path))
        assert reader.exists("checkpoint-model")
        assert os.path.exists(cm._path("checkpoint-model") + ".next"), \
            "recovery threw away a live writer's params .next"
        assert _pair_vals(reader) == (1.0, 1.0)
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)
    # the writer is gone: its lone .next is crash debris now
    fresh = CheckpointManager(str(tmp_path))
    assert _pair_vals(fresh) == (1.0, 1.0)
    assert _debris(fresh) == []


def save_dies_mid_state_write(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    _save_pair_vals(cm, 1.0, 1.0)
    real = cm._save_file
    calls = []

    def dying(path, tree):
        calls.append(path)
        if len(calls) == 2:                  # the state file
            with open(path + ".tmp", "wb") as f:
                f.write(b"half a file")
            raise RuntimeError("killed during the state write")
        real(path, tree)

    cm._save_file = dying
    with pytest.raises(RuntimeError):
        _save_pair_vals(cm, 2.0, 2.0)
    cm._save_file = real
    fresh = CheckpointManager(str(tmp_path))
    assert _pair_vals(fresh) == (1.0, 1.0)
    _save_pair_vals(fresh, 3.0, 3.0)         # a healthy save cleans up
    assert _pair_vals(fresh) == (3.0, 3.0)
    assert _debris(fresh) == []


def supersede_and_count_bound(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    gate, written = _gated(cm)
    for i in range(5):
        cm.save_tree("checkpoint-model", _tree(i), background=True)
        assert len(cm._pending) <= cm.MAX_PENDING
    assert cm.superseded_saves >= 2
    gate.set()
    cm.flush()
    assert written[-1] == 4.0                # the newest tree landed last
    assert _val(cm, "checkpoint-model") == 4.0


def byte_budget(tmp_path):
    cm = CheckpointManager(str(tmp_path), snapshot_budget_bytes=1024)
    gate, _ = _gated(cm)
    big = {"w": torch.zeros(600)}            # 2.4 KB, over the budget alone
    # a lone snapshot over the budget still goes (else a large model could
    # never checkpoint)
    cm.save_tree("best-model", big, background=True)
    assert len(cm._pending) == 1
    done = threading.Event()

    def second():
        cm.save_tree("final-model", big, background=True)
        done.set()

    th = threading.Thread(target=second, daemon=True)
    th.start()
    time.sleep(0.5)
    # the second submission waits for the first save instead of pinning a
    # second snapshot
    assert not done.is_set()
    gate.set()
    assert done.wait(GATE_S)
    th.join(GATE_S)
    assert not th.is_alive()
    cm.flush()
    assert cm.exists("best-model") and cm.exists("final-model")


def budget_allows_small_saves(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    gate, _ = _gated(cm)
    cm.save_tree("best-model", _tree(1.0), background=True)
    cm.save_tree("final-model", _tree(2.0), background=True)
    assert len(cm._pending) == 2              # neither waited
    gate.set()
    cm.flush()
    assert _val(cm, "best-model") == 1.0 and _val(cm, "final-model") == 2.0


def pair_bytes_counted(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    gate, _ = _gated(cm)
    params = {"w": torch.zeros(100)}                       # 400 B
    state = {"epoch": 1, "w": torch.zeros(50, dtype=torch.float64)}  # 400 B
    cm.save_pair(params, state, background=True)
    assert cm._pending[0][2] == 800
    gate.set()
    cm.flush()


def background_save_is_the_submitted_state(tmp_path):
    # the optimizer updates in place right after a save is submitted: the
    # file must hold the values at submission
    cm = CheckpointManager(str(tmp_path))
    gate, _ = _gated(cm)
    params, moment = _tree(1.0), _tree(1.0)
    cm.save_pair(params, {"epoch": 1, "optimizer": {"m": moment["w"]},
                          "w": moment["w"]}, background=True)
    params["w"].add_(5.0)
    moment["w"].mul_(7.0)
    gate.set()
    cm.flush()
    assert _val(cm, "checkpoint-model") == 1.0
    state = cm.restore_tree("state_dict_checkpoint")
    assert float(state["optimizer"]["m"][0]) == 1.0
    # one tensor under two keys is written once and read back shared
    assert state["optimizer"]["m"].data_ptr() == state["w"].data_ptr()


def metadata_after_background_save(tmp_path):
    out = str(tmp_path / "meta")
    es = EarlyStopping(Logger(out), out)
    gate, _ = _gated(es.ckpt)
    es(torch.nn.Linear(2, 2), score=0.5, epoch=1, answer_spaces=["a", "b"])
    time.sleep(0.1)
    for name in ("model_ckpt_info.json", "model-metrics.json"):
        assert es.ckpt.read_json(name) is None, name
    gate.set()
    es.ckpt.flush()
    assert es.ckpt.read_json("model_ckpt_info.json")["best_score"] == 0.5
    assert es.ckpt.read_json("model-metrics.json") == {"best-score": 0.5}
    assert es.ckpt.exists("best-model")


def managers_in_two_threads(tmp_path):
    a = CheckpointManager(str(tmp_path))
    b = CheckpointManager(str(tmp_path))
    a.save_tree("best-model", _tree(0.0))
    errors = []

    def writer():
        try:
            for i in range(1, 15):
                a.save_tree("best-model", _tree(i))
        except Exception as e:                       # pragma: no cover
            errors.append(e)

    def reader():
        try:
            for _ in range(40):
                v = _val(b, "best-model")
                assert v == int(v) and 0.0 <= v <= 14.0
        except Exception as e:                       # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=writer), threading.Thread(target=reader)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(GATE_S)
        assert not t.is_alive()
    assert errors == []
    assert _val(a, "best-model") == 14.0


_HOLDER = r"""
import sys
from t5_resnet_vqa_torch.train.callbacks import CheckpointManager
cm = CheckpointManager(sys.argv[1])
with cm._guard():
    print("HELD", flush=True)
    sys.stdin.readline()
print("RELEASED", flush=True)
"""


def second_process_guard(tmp_path):
    holder = subprocess.Popen(
        [sys.executable, "-c", _HOLDER, str(tmp_path)], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, text=True)
    try:
        assert holder.stdout.readline().strip() == "HELD"
        cm = CheckpointManager(str(tmp_path))
        th = threading.Thread(target=cm.save_tree,
                              args=("best-model", _tree(3.0)), daemon=True)
        th.start()
        time.sleep(0.5)
        assert th.is_alive(), "the save did not wait for the other process"
        assert not os.path.exists(cm._path("best-model"))
        holder.stdin.write("\n")
        holder.stdin.flush()
        th.join(GATE_S)
        assert not th.is_alive()
        assert _val(cm, "best-model") == 3.0
        assert holder.wait(GATE_S) == 0
    finally:
        holder.kill()


CASES = [lone_next_adopted, interrupted_swap_finished,
         lone_params_next_discarded, both_nexts_adopted, live_writer_skipped,
         save_dies_mid_state_write, supersede_and_count_bound, byte_budget,
         budget_allows_small_saves, pair_bytes_counted,
         background_save_is_the_submitted_state,
         metadata_after_background_save, managers_in_two_threads,
         second_process_guard]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_checkpoint_manager(case, tmp_path):
    case(tmp_path)
