"""The ViT families' train step on a (data, model) mesh against the JAX
package's step on the 2x2 JAX mesh and against the port's own one-device
run: ViT + T5 encoder-decoder (T5's ``relative_attention_bias`` read by
head under tp, the decoder's cross-attention, the tied table) and ViT x
RoBERTa (RoBERTa's layers at S = 17 + 16, the frozen ViT layers split
too). The setup and the tolerances are ``test_torch_mesh_train.py``'s.
"""

import pytest

import test_torch_mesh_train as base

FAMILIES = ("vit", "cross")


@pytest.mark.parametrize("family", FAMILIES)
def test_mesh_steps_match_jax_mesh(family, tmp_path_factory):
    base.check_against_jax_mesh(family, (2, 2), tmp_path_factory)


@pytest.mark.parametrize("family", FAMILIES)
def test_mesh_steps_match_one_device(family, tmp_path_factory):
    base.check_against_one_device(family, tmp_path_factory)
