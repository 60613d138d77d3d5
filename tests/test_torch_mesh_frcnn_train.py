"""The Faster-RCNN family's train step on a (data, model) mesh against the
JAX package's step on the 2x2 JAX mesh and against the port's own
one-device run (the ResNet-50 body through the bottleneck's plain version
on every rank, the FPN ``pool`` level, T5 and the SGA split over the model
axis). The setup and the tolerances are ``test_torch_mesh_train.py``'s.
"""

import test_torch_mesh_train as base


def test_mesh_steps_match_jax_mesh(tmp_path_factory):
    base.check_against_jax_mesh("faster_rcnn", (2, 2), tmp_path_factory)


def test_mesh_steps_match_one_device(tmp_path_factory):
    base.check_against_one_device("faster_rcnn", tmp_path_factory)
