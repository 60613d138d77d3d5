"""Full-width parity of the Faster-RCNN and cross-attention families
against the JAX package on the CPU (marker ``slow``: both packages hold a
full-width model, and JAX compiles it).

* ``FasterRcnnVQAModel``: ResNet-50 body + FPN 256 + T5-base (12 layers,
  d_model 768) + 3 SGA blocks (H=8, D=96), 170 answers, one 256x256 uint8
  image, kernel routes on (their plain versions on the CPU);
* ``CrossAttentionVitVQAModel``: ViT-base x RoBERTa-base, 12 interleaved
  layers, 197 + 16 tokens, 170 answers, one 224x224 uint8 image.

JAX ``model.init`` params (the BatchNorms and the ViT's CLS and position
embeddings randomised) reach the port through the weight bridge and a
strict load; log-probs and loss within 1e-4 (fp32).
"""

import jax
import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.models.cross_attention_vqa import (
    CrossAttentionVitVQAModel as JaxCross,
)
from t5_resnet_vqa_tpu.models.faster_rcnn_vqa import (
    FasterRcnnVQAModel as JaxFrcnn,
)
from t5_resnet_vqa_torch.models import (
    CrossAttentionVitVQAModel,
    FasterRcnnVQAModel,
)
from t5_resnet_vqa_torch.utils import (
    cross_attention_state_dict_from_jax,
    faster_rcnn_state_dict_from_jax,
)

from test_torch_faster_rcnn import randomize_batchnorms

pytestmark = pytest.mark.slow

ANSWERS = 170


@pytest.mark.parametrize("family", ["faster_rcnn", "cross"])
def test_full_width_forward_matches_jax(family):
    rng = np.random.default_rng(0)
    ids = rng.integers(2, 32000, (1, 16)).astype(np.int32)
    ids[0, 9], ids[0, 10:] = 1, 0
    labels = np.array([7], np.int32)
    if family == "faster_rcnn":
        jmodel = JaxFrcnn(answer_spaces=ANSWERS)
        batch = dict(question_input_ids=ids,
                     question_attention_masks=(ids != 0).astype(np.int32),
                     image_tensors=rng.integers(0, 256, (1, 256, 256, 3),
                                                dtype=np.uint8))
    else:
        jmodel = JaxCross(answer_spaces=ANSWERS)
        batch = dict(question_input_ids=ids,
                     pixel_values=rng.integers(0, 256, (1, 224, 224, 3),
                                               dtype=np.uint8))
    params = jax.tree_util.tree_map(
        np.array, jmodel.init(jax.random.PRNGKey(0), **batch)["params"])
    if family == "faster_rcnn":
        params = randomize_batchnorms(params, rng)
        model = FasterRcnnVQAModel(ANSWERS, device="cpu")
        state = faster_rcnn_state_dict_from_jax(params)
    else:
        emb = params["vit_embeddings"]
        for k in ("cls_token", "position_embeddings"):
            emb[k] = rng.normal(0.0, 0.02, emb[k].shape).astype(np.float32)
        model = CrossAttentionVitVQAModel(ANSWERS, device="cpu")
        state = cross_attention_state_dict_from_jax(params)
    model.load_state_dict(state, strict=True)
    want_lp, want_loss = jmodel.apply({"params": params}, **batch,
                                      annotation_ids=labels)
    with torch.inference_mode():
        lp, loss = model.eval()(
            **{k: torch.from_numpy(v) for k, v in batch.items()},
            annotation_ids=torch.from_numpy(labels))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=0,
                               atol=1e-4)
