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
``--set trainer_kwargs.device=cpu`` names the CPU.

``--data-parallel DP --model-parallel TP`` (both 1 by default) serve on a
(data, model) mesh of DP x TP ranks, started as the training entry point
starts them (``parallel/launch.py``; under ``torchrun`` the processes join
the group they find): the batch is split over the data axis (it must
divide by DP) and the model over the model axis. Rank 0 binds the port and
hands each request batch to the other ranks (``eval/session.py``,
``MeshLeader``), which follow until it closes.
"""

import argparse
import signal
from typing import Optional, Tuple

from .core.config import Config
from .eval.http_server import VQAHTTPServer
from .eval.session import MeshLeader, VQAInferenceSession, follow
from .parallel import launch


def parse_args(argv=None) -> Tuple[argparse.Namespace, Config,
                                   Optional[Tuple[int, int]]]:
    """(arguments, config, (data, model) sizes of the mesh or None). A
    mesh that does not fit the visible cards or a batch that does not
    divide over its data axis is refused before anything loads."""
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
                   help="shard the serving batch DP ways over a device "
                        "mesh (batch-size must divide)")
    p.add_argument("--model-parallel", type=int, default=1, metavar="TP",
                   help="tensor-parallel degree on the mesh model axis "
                        "(same Megatron specs as training)")
    args = p.parse_args(argv)
    cfg = Config.from_json(args.config, overrides=args.set)
    if args.data_parallel * args.model_parallel == 1:
        return args, cfg, None
    device_type = "cpu" if cfg.trainer.device == "cpu" else "cuda"
    try:
        dp = launch.resolve_mesh_size(args.data_parallel,
                                      args.model_parallel, device_type)
    except ValueError as e:
        p.error(str(e))
    if args.batch_size % dp:
        p.error(f"--batch-size {args.batch_size} must be divisible by "
                f"--data-parallel {dp} (each data shard serves batch/dp "
                f"pairs)")
    return args, cfg, (dp, args.model_parallel)


def make_server(args: argparse.Namespace, session) -> VQAHTTPServer:
    server = VQAHTTPServer(session, host=args.host, port=args.port,
                           default_top_k=args.top_k, logger=print,
                           image_root=args.image_root)
    print(f"serving {session.family} family "
          f"({len(session.answer_spaces)}-answer space) "
          f"on http://{server.host}:{server.port} "
          f"(batch {session.batch_size})", flush=True)
    return server


def build_server(argv=None) -> VQAHTTPServer:
    """Parse the arguments, restore the session and bind the server (one
    device; ``main`` starts the ranks of a mesh)."""
    args, cfg, shape = parse_args(argv)
    if shape is not None:
        raise ValueError("a mesh is served by main(), which starts one "
                         "process per rank")
    session = VQAInferenceSession.from_checkpoint(cfg,
                                                  batch_size=args.batch_size)
    return make_server(args, session)


def serve_rank(rank: int, args: argparse.Namespace, cfg: Config,
               shape: Tuple[int, int], until=None) -> Optional[int]:
    """One rank of a served mesh. Rank 0 serves until interrupted, or, with
    ``until``, runs ``until(server)`` on the bound server and returns its
    result; the other ranks follow it and return the number of calls."""
    from .parallel import make_mesh
    mesh = make_mesh(*shape)
    session = VQAInferenceSession.from_checkpoint(
        cfg, batch_size=args.batch_size, mesh=mesh)
    if not mesh.is_writer:
        # an interrupt stops rank 0, whose close() releases this loop
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        return follow(session)
    leader = MeshLeader(session)
    print(f"serving mesh: {mesh.shape}", flush=True)
    server = make_server(args, leader)
    try:
        if until is not None:
            server.start()
            return until(server)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        leader.close()
    return None


def main(argv=None) -> None:
    args, cfg, shape = parse_args(argv)
    if shape is None:
        server = make_server(args, VQAInferenceSession.from_checkpoint(
            cfg, batch_size=args.batch_size))
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            server.close()
        return
    device_type = "cpu" if cfg.trainer.device == "cpu" else "cuda"
    # the ranks' processes find the function by its module's own name, not
    # as __main__'s
    from t5_resnet_vqa_torch.serve import serve_rank as rank_fn
    try:
        launch.launch_mesh(rank_fn, (args, cfg, shape), shape[0], shape[1],
                           device_type)
    except KeyboardInterrupt:   # the ranks have closed and been joined
        pass


if __name__ == "__main__":
    main()
