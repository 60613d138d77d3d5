"""CNN-family training entry point of the port (the counterpart of the
repo-root ``train_faster_rcnn_vqa.py``):

    python -m t5_resnet_vqa_torch.train --config vit_daquar_config.json \
        --set trainer_kwargs.epochs=3

Loads the six-group JSON config with dotted ``--set`` overrides, reads the
answer space, builds the CNN-family model named by
``model_kwargs.vision_model_name`` (a ViT name in the shared reference file
means resnet50 here, as in the JAX entry point), and trains. It runs on
the card unless ``--set trainer_kwargs.device=cpu`` names the CPU. The
Faster-RCNN tower (ResNet-50 + FPN) is
``--set model_kwargs.vision_model_name=faster-rcnn``.

To resume a killed run, run the same command with
``--set trainer_kwargs.load_from_checkpoint=true``: the trainer takes the
last ``checkpoint-model.pt`` + ``state_dict_checkpoint.pt`` pair under
``<output_dir>/model_checkpoints`` (weights, optimizer and schedule, epoch
and step; the interrupted epoch runs again), or ``best-model.pt`` weights
alone where no pair exists. ``trainer_kwargs.checkpoint_every_steps=N``
also writes the pair every N steps. The
ViT families have their own entry point,
``python -m t5_resnet_vqa_torch.train.vit``.

``--data-parallel DP --model-parallel TP`` trains on a (data, model) mesh
(``parallel/``): ``0`` (the default) is no mesh, ``-1`` all visible cards
over TP. Without ``torchrun``'s environment the command starts DP x TP
ranks itself, on the first DP x TP cards with NCCL, or with
``--set trainer_kwargs.device=cpu`` on the CPU with gloo; under
``torchrun --nproc-per-node N`` each process joins the group it finds. A
mesh larger than the visible cards is refused.
"""

import argparse
from typing import Optional, Tuple

from ..core.config import Config
from ..parallel import launch
from .trainer import VQATrainer, train_rank


def parse_args(argv=None, default_vision: str = "resnet50",
               description: str = __doc__
               ) -> Tuple[Config, Optional[Tuple[int, int]]]:
    """(config, (data, model) sizes of the mesh or None)."""
    p = argparse.ArgumentParser(description=description,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="vit_daquar_config.json",
                   help="six-group JSON config (reference layout accepted)")
    p.add_argument("--set", action="append", default=[], metavar="GROUP.KEY=V",
                   help="config override, e.g. trainer.epochs=3")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="data-axis size (0 = no mesh, 1 device; -1 = all "
                        "visible cards over the model axis)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="model(TP)-axis size")
    args = p.parse_args(argv)
    cfg = Config.from_json(args.config, overrides=args.set)
    if cfg.model.vision_model_name.startswith("google/"):
        cfg.model.vision_model_name = default_vision
    if not args.data_parallel:
        if args.model_parallel != 1:
            p.error("--model-parallel needs --data-parallel (0 is no mesh)")
        return cfg, None
    device_type = "cpu" if cfg.trainer.device == "cpu" else "cuda"
    try:
        dp = launch.resolve_mesh_size(args.data_parallel,
                                      args.model_parallel, device_type)
    except ValueError as e:
        p.error(str(e))
    return cfg, (dp, args.model_parallel)


def train(cfg: Config, shape: Optional[Tuple[int, int]]) -> None:
    """Train on one device, or on every rank of a mesh of ``shape``."""
    if shape is None:
        VQATrainer.from_config(cfg).train()
        return
    device_type = "cpu" if cfg.trainer.device == "cpu" else "cuda"
    launch.launch_mesh(train_rank, (cfg, shape), shape[0], shape[1],
                       device_type)


def main(argv=None) -> None:
    train(*parse_args(argv))


if __name__ == "__main__":
    main()
