"""Rank functions of the mesh tests (``tests/test_torch_mesh_*.py``); the
module holds no test of its own.

They run in processes that ``parallel.launch.spawn`` starts, which import
this module by name: it imports the port and torch, never JAX (the test
modules import JAX and set XLA flags). Each function builds the meshes it
is given in order on every rank (group creation is collective) and runs on
the ranks that belong to each; rank 0 returns numpy results.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from t5_resnet_vqa_torch.core.config import (
    Config,
    LRSchedulerConfig,
    OptimizerConfig,
)
from t5_resnet_vqa_torch.parallel import make_mesh
from t5_resnet_vqa_torch.parallel import sharding as shd
from t5_resnet_vqa_torch.parallel.tensor_parallel import TensorParallel, tp_dim

Shape = Tuple[int, int]


def build_model(family: str, kw: Dict[str, Any]) -> torch.nn.Module:
    """A small port model of ``family`` (CPU, fp32) from plain kwargs."""
    from t5_resnet_vqa_torch.models import (
        CrossAttentionVitVQAModel,
        FasterRcnnVQAModel,
        ResnetVQAModel,
        RobertaConfig,
        T5Config,
        ViTConfig,
        VitVQAModel,
    )
    from t5_resnet_vqa_torch.ops import AttentionConfig

    kw = dict(kw)
    answers = kw.pop("answers")
    common = dict(device="cpu", use_kernels=True,
                  fine_tune_vision=kw.pop("fine_tune_vision", False))
    if "seed" in kw:
        common["generator"] = torch.Generator().manual_seed(kw.pop("seed"))
    if family in ("cnn", "faster_rcnn"):
        t5 = T5Config(**kw.pop("t5"))
        sga = AttentionConfig(**kw.pop("sga"))
        if family == "cnn":
            return ResnetVQAModel(answers, t5_config=t5, sga_config=sga,
                                  **kw, **common)
        return FasterRcnnVQAModel(answers, t5_config=t5, sga_config=sga,
                                  **kw, **common)
    if family == "vit":
        return VitVQAModel(answers, t5_config=T5Config(**kw.pop("t5")),
                           vit_config=ViTConfig(**kw.pop("vit")), **kw,
                           **common)
    vit = ViTConfig(**kw.pop("vit"))
    roberta = dataclasses.replace(RobertaConfig.tiny(), **kw.pop("roberta"))
    return CrossAttentionVitVQAModel(answers, vit_config=vit,
                                     roberta_config=roberta, **kw, **common)


def _numpy(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().float().cpu().numpy() for k, v in sd.items()}


def _mesh_model(spec, mesh):
    """The spec's model with the spec's full weights, split over ``mesh``
    for training as the trainer splits it."""
    from t5_resnet_vqa_torch.train.trainer import shard_for_training_
    model = build_model(spec["family"], spec["model"])
    model.load_state_dict(spec["state"], strict=True)
    model.to(mesh.device)
    return shard_for_training_(model, mesh)


def _local(batch: Dict[str, np.ndarray], mesh) -> Dict[str, torch.Tensor]:
    rows = mesh.batch_rows(len(batch["annotation_ids"]))
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])).to(mesh.device)
            for k, v in batch.items()}


def _run_steps(spec: Dict[str, Any], mesh) -> Tuple[torch.nn.Module, list]:
    """The spec's steps of the trainer's train step (``setup_train_step``:
    DDP over the data axis, the clip and the optimizer of ``spec``) on the
    spec's batches: (the split model, the losses averaged over the data
    axis)."""
    from t5_resnet_vqa_torch.train.trainer import setup_train_step

    torch.manual_seed(spec.get("seed", 0))
    model = build_model(spec["family"], spec["model"])
    model.load_state_dict(spec["state"], strict=True)
    model.to(mesh.device).train()
    config = Config(
        optimizer=OptimizerConfig(**spec["optimizer"]),
        lr_scheduler=LRSchedulerConfig(num_warmup_steps=spec["warmup"]))
    config.trainer.gradient_clipping = spec.get("clip", 1.0)
    _, _, _, step = setup_train_step(model, config, len(spec["batches"]),
                                     mesh=mesh)
    losses = []
    for batch in spec["batches"]:
        loss, _ = step(_local(batch, mesh))
        losses.append(float(shd.mean_over_data(loss.detach(), mesh)))
    return model, losses


def train_steps(rank: int, spec: Dict[str, Any], shapes: Sequence[Shape]
                ) -> List[Dict[str, Any]]:
    """For each mesh shape, ``_run_steps``; rank 0 returns per shape the
    losses and the gathered full weights."""
    out = []
    for shape in shapes:
        mesh = make_mesh(*shape)
        if not mesh.member:
            out.append(None)
            continue
        model, losses = _run_steps(spec, mesh)
        full = shd.gather_state_dict(model.state_dict(), mesh)
        out.append({"losses": losses, "state": _numpy(full)}
                   if rank == 0 else None)
    return out


def local_params_after_steps(rank: int, spec: Dict[str, Any], shape: Shape
                             ) -> Dict[str, Any]:
    """``_run_steps`` on one mesh; every rank returns its place on the mesh
    and the bytes of its own parameters (replicated and split), by name."""
    mesh = make_mesh(*shape)
    model, losses = _run_steps(spec, mesh)
    return {"data": mesh.data_index, "model": mesh.model_index,
            "losses": losses,
            "split": {n for n, p in model.named_parameters()
                      if tp_dim(p) is not None},
            "params": {n: p.detach().cpu().numpy().tobytes()
                       for n, p in model.named_parameters()}}


def optimizer_steps(rank: int, spec: Dict[str, Any], shapes: Sequence[Shape]
                    ) -> List[Dict[str, Any]]:
    """For each mesh shape: ``spec["steps"]`` steps of Lamb or Adafactor
    (built directly, so that ``min_dim_size_to_factor`` can be small) with
    the clip, on one repeated batch. Rank 0 returns the losses, the full
    weights and the full optimizer state of the trainable parameters."""
    from t5_resnet_vqa_torch.parallel.tensor_parallel import clip_grad_norm_
    from t5_resnet_vqa_torch.train.optimizer import (
        Adafactor,
        Lamb,
        state_split_dim,
    )

    out = []
    for shape in shapes:
        mesh = make_mesh(*shape)
        if not mesh.member:
            out.append(None)
            continue
        model = _mesh_model(spec, mesh)
        model.train()
        tp = TensorParallel.of(mesh)
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        params = [p for _, p in named]
        if spec["type"] == "Lamb":
            opt = Lamb(params, lr=1e-2, weight_decay=0.1, tp=tp)
        else:
            opt = Adafactor(params, lr=1e-2,
                            min_dim_size_to_factor=spec["min_dim"], tp=tp)
        batch = _local(spec["batch"], mesh)
        losses = []
        for _ in range(spec["steps"]):
            opt.zero_grad(set_to_none=True)
            _, loss = model(**batch)
            loss.backward()
            clip_grad_norm_(params, 1.0, tp)
            opt.step()
            losses.append(float(loss.detach()))
        full = shd.gather_state_dict(model.state_dict(), mesh)
        state = {}
        for name, p in named:
            for key, value in opt.state[p].items():
                dim = state_split_dim(opt, p, key, mesh.model)
                if dim is not None:
                    value = shd.all_gather_cat(value, mesh.tp_group, dim,
                                               mesh.model)
                state[f"{name}/{key}"] = value.float().cpu().numpy()
        factored_local = sorted(
            n for n, p in named
            if tp_dim(p) is not None and "v_row" in opt.state[p])
        out.append({"losses": losses, "state": _numpy(full),
                    "opt": state, "factored_split": factored_local}
                   if rank == 0 else None)
    return out


def serve(rank: int, spec: Dict[str, Any], shapes: Sequence[Any]
          ) -> List[Dict[str, Any]]:
    """For each mesh shape (None: one device, on every rank): a session
    over the spec's full weights, ``ask_batch`` on the spec's requests and,
    for the ViT family, greedy ``generate_batch``. Every rank returns what
    it decoded (all ranks of a mesh must agree)."""
    from t5_resnet_vqa_torch.eval import VQAInferenceSession

    out = []
    for shape in shapes:
        mesh = make_mesh(*shape) if shape is not None else None
        if mesh is not None and not mesh.member:
            out.append(None)
            continue
        session = VQAInferenceSession(
            build_model(spec["family"], spec["model"]), spec["state"],
            spec["answers"], family=spec["family"],
            batch_size=spec["batch_size"], image_size=spec["image_size"],
            device="cpu", mesh=mesh)
        rec = {"ask": session.ask_batch(spec["requests"], top_k=3)}
        if spec["family"] == "vit":
            rec["generate"] = session.generate_batch(
                spec["requests"], max_answer_length=3)
        out.append(rec)
    return out


def session_refuses_indivisible_batch(rank: int, spec: Dict[str, Any]
                                      ) -> str:
    from t5_resnet_vqa_torch.eval import VQAInferenceSession
    mesh = make_mesh(2, 1)
    try:
        VQAInferenceSession(build_model(spec["family"], spec["model"]), None,
                            spec["answers"], batch_size=3, device="cpu",
                            mesh=mesh)
    except ValueError as e:
        return str(e)
    return ""


def _http_calls(server) -> Dict[str, Any]:
    """Rank 0's requests to its own server: health, one ask, one batch of
    three, a generate the CNN family refuses (400), then the calls the
    followers ran."""
    import json
    import urllib.error
    import urllib.request

    def call(method, path, body=None):
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}{path}", method=method,
            data=None if body is None else json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    image = os.environ["MESH_TEST_IMAGE"]
    return {"health": call("GET", "/healthz"),
            "ask": call("POST", "/v1/ask", {"image_path": image,
                                            "question": "what is here",
                                            "top_k": 2}),
            "batch": call("POST", "/v1/ask_batch", {"requests": [
                {"image_path": image, "question": f"what is {i}"}
                for i in range(3)]}),
            "generate": call("POST", "/v1/generate",
                             {"image_path": image, "question": "what"})}


def http_rank(rank: int, argv: List[str], spec: Dict[str, Any],
              image: str) -> Any:
    """One rank of ``python -m t5_resnet_vqa_torch.serve`` on a mesh, the
    factory building the spec's small model: rank 0 serves its own
    requests (``_http_calls``), the others follow."""
    from t5_resnet_vqa_torch import serve
    from t5_resnet_vqa_torch.train import factory

    os.environ["MESH_TEST_IMAGE"] = image
    factory.build_model = lambda cfg, n, device=None, generator=None: (
        build_model(spec["family"], spec["model"]).to(device),
        spec["family"])
    args, cfg, shape = serve.parse_args(argv)
    return serve.serve_rank(rank, args, cfg, shape, until=_http_calls)


def trainer_run(rank: int, config_path: str, spec: Dict[str, Any],
                shape: Shape) -> None:
    """A ``VQATrainer`` on a mesh from a config file and the spec's model
    (built the same on every rank)."""
    from t5_resnet_vqa_torch.data import load_answer_spaces
    from t5_resnet_vqa_torch.train import VQATrainer

    mesh = make_mesh(*shape)
    cfg = Config.from_json(config_path)
    dk = cfg.dataset
    answers = load_answer_spaces(os.path.join(dk.root_data_dir,
                                              dk.answer_spaces_file))
    model = build_model(spec["family"], spec["model"])
    if "state" in spec:
        model.load_state_dict(spec["state"], strict=True)
    VQATrainer(model, cfg, answers, mesh=mesh).train()


def mesh_rules(rank: int) -> Dict[str, Any]:
    """On 4 ranks: the grid order, the groups, a mesh smaller than the
    world, JAX's errors, the exact gather and the fp32 sum of bf16."""
    import torch.distributed as dist
    out: Dict[str, Any] = {}
    mesh = make_mesh(2, 2)
    out["place"] = (mesh.data_index, mesh.model_index)
    out["rows"] = (mesh.batch_rows(8).start, mesh.batch_rows(8).stop)
    out["tp_peers"] = dist.get_process_group_ranks(mesh.tp_group)
    out["dp_peers"] = dist.get_process_group_ranks(mesh.dp_group)
    out["minus_one"] = make_mesh(-1, 2).shape
    small = make_mesh(1, 2)
    out["small_member"] = small.member
    errors = []
    for shape in ((-1, 3), (3, 2), (2, 0)):
        try:
            make_mesh(*shape)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors
    try:
        mesh.batch_rows(6 + 1)
    except ValueError as e:
        out["rows_error"] = str(e)
    # a tensor with -0.0 and a NaN payload survives the gather bit for bit
    part = torch.tensor([[-0.0, float(rank)], [float("nan"), 1e-38]])
    got = shd.all_gather_cat(part, mesh.tp_group, 0, 2)
    out["gather_bits"] = got.view(torch.int32).tolist()
    out["part_bits"] = part.view(torch.int32).tolist()
    # 1 on rank 0 and 2^-8 elsewhere: summed in bf16 each addition would
    # round back to 1
    x = torch.tensor([1.0 if rank == 0 else 2.0 ** -8], dtype=torch.bfloat16)
    out["bf16_sum"] = shd.all_reduce_sum(x, mesh.mesh_group).float().item()
    out["bf16_dtype"] = str(shd.all_reduce_sum(x, mesh.mesh_group).dtype)
    out["object"] = shd.broadcast_object({"rank": rank}, mesh)
    return out
