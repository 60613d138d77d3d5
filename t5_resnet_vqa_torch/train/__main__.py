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
"""

import argparse

from ..core.config import Config
from .trainer import VQATrainer


def parse_args(argv=None, default_vision: str = "resnet50",
               description: str = __doc__) -> Config:
    p = argparse.ArgumentParser(description=description,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="vit_daquar_config.json",
                   help="six-group JSON config (reference layout accepted)")
    p.add_argument("--set", action="append", default=[], metavar="GROUP.KEY=V",
                   help="config override, e.g. trainer.epochs=3")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="data-axis size of a mesh (not ported: must be 0)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="model-axis size of a mesh (not ported: must be 1)")
    args = p.parse_args(argv)
    if args.data_parallel or args.model_parallel != 1:
        raise NotImplementedError(
            "the port trains on one device; a mesh comes with ROADMAP.md, "
            "modules item 11")
    cfg = Config.from_json(args.config, overrides=args.set)
    if cfg.model.vision_model_name.startswith("google/"):
        cfg.model.vision_model_name = default_vision
    return cfg


def main(argv=None) -> None:
    VQATrainer.from_config(parse_args(argv)).train()


if __name__ == "__main__":
    main()
