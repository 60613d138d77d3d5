"""Heatmap and test-set WUPS evaluation CLI of the port (the counterpart of
the repo-root ``CNN_vqa_heatmap.py`` and ``ViT_vqa_heatmap.py``):

    python -m t5_resnet_vqa_torch.viz --mode cam --config config.json \
        [--set trainer_kwargs.output_dir=/run] [--top-k 3] [--batch-size 4]

Reads the answer space from ``model_ckpt_info.json`` and the weights from
``best-model.pt`` under the config's output directory
(``VQAInferenceSession.from_checkpoint``), runs the DAQUAR test split
through the harness of ``viz/heatmap.py`` (``--mode cam``: channel-mean
CAMs of the CNN family, the FPN's ``pool`` level alone for Faster-RCNN;
``--mode rollout``: attention rollout of the ViT family), writes the
overlays and ``predictions.json`` under ``<output_dir>/heatmaps`` (or
``--output-dir``) and prints the average test WUPS. It runs on the card
unless ``--set trainer_kwargs.device=cpu`` names the CPU. The
cross-attention family returns no attention maps, as in the JAX package,
and is refused. The overlays need OpenCV (``cv2``).
"""

import argparse
import os

from ..core.config import Config
from ..data import DaquarCnnCollate, DaquarDataset, DaquarVitCollate, DataLoader
from ..eval.session import (
    CNN_FAMILY,
    CROSS_FAMILY,
    VIT_FAMILY,
    VQAInferenceSession,
)
from .heatmap import generate_heatmaps, make_infer_fn

MODE_FAMILY = {"cam": CNN_FAMILY, "rollout": VIT_FAMILY}


def main(argv=None) -> float:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--mode", choices=sorted(MODE_FAMILY), default="cam")
    p.add_argument("--config", default="vit_daquar_config.json")
    p.add_argument("--set", action="append", default=[], metavar="G.K=V")
    p.add_argument("--output-dir", default=None,
                   help="heatmap output dir (default <output_dir>/heatmaps)")
    p.add_argument("--top-k", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=4)
    args = p.parse_args(argv)

    cfg = Config.from_json(args.config, overrides=args.set)
    session = VQAInferenceSession.from_checkpoint(cfg,
                                                  batch_size=args.batch_size)
    if session.family == CROSS_FAMILY:
        raise SystemExit(
            "the cross-attention family returns no attention maps (nor "
            "does the JAX package's): heatmaps need the CNN family (--mode "
            "cam) or the ViT family (--mode rollout)")
    if session.family != MODE_FAMILY[args.mode]:
        raise SystemExit(f"--mode {args.mode} needs the "
                         f"{MODE_FAMILY[args.mode]!r} family; the checkpoint "
                         f"holds a {session.family!r} model")

    dk = cfg.dataset
    dataset = DaquarDataset(dk.root_data_dir, dk.test_csv_file, dk.images_dir,
                            "test")
    # the JAX CLI's eval collate: the config's image path and tokenizer,
    # seed 0, no reduced decode
    tokenizer = session.collate.tokenizer
    if args.mode == "cam":
        collate = DaquarCnnCollate(
            session.answer_spaces, dk.interpolation_strategy,
            resizing_dimensions=(dk.image_size, dk.image_size),
            lang_model=dk.language_model_tokenizer, eval_mode=True,
            tokenizer=tokenizer, emit_uint8=dk.uint8_wire_images)
    else:
        collate = DaquarVitCollate(
            session.answer_spaces, lang_model=dk.language_model_tokenizer,
            eval_mode=True, tokenizer=tokenizer,
            emit_uint8=dk.uint8_wire_images)
    loader = DataLoader(dataset, collate, args.batch_size,
                        drop_remainder=False)
    infer_fn = make_infer_fn(session.model, args.mode, args.top_k,
                             session.compute_dtype)
    out_dir = args.output_dir or os.path.join(cfg.trainer.output_dir,
                                              "heatmaps")
    return generate_heatmaps(infer_fn, loader, session.answer_spaces,
                             out_dir, mode=args.mode, top_k=args.top_k)


if __name__ == "__main__":
    main()
