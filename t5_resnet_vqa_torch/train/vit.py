"""ViT-family training entry point of the port (the counterpart of the
repo-root ``train_vit_vqa.py``):

    python -m t5_resnet_vqa_torch.train.vit --config vit_daquar_config.json \
        --set trainer_kwargs.epochs=3

The CNN entry point's arguments and config (``train/__main__.py``), with the
vision model set to ``google/vit-base-patch16-224-in21k`` whatever the
config names: ViT-base + T5-base encoder-decoder, or, with
``--set model_kwargs.language_model_name=roberta-base``, the ViT-base x
RoBERTa-base cross-attention family. It runs on the card unless
``--set trainer_kwargs.device=cpu`` names the CPU; ``--data-parallel`` and
``--model-parallel`` make a mesh as for the CNN family.
"""

from .__main__ import parse_args, train

VIT_MODEL_NAME = "google/vit-base-patch16-224-in21k"


def main(argv=None) -> None:
    cfg, shape = parse_args(argv, description=__doc__)
    cfg.model.vision_model_name = VIT_MODEL_NAME
    train(cfg, shape)


if __name__ == "__main__":
    main()
