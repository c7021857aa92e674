"""The port's training-state checkpoint (`utils/checkpoint.py:
save_training_state`, `load_training_state`) on the CPU: its round trip,
files written by either package loaded by the other with equal arrays, a
`torch.optim` optimizer resumed bit-identically, and the atomic write.
"""

import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import haskell_path_tracer_tpu as J
from haskell_path_tracer_tpu.diff import grad as JG
from haskell_path_tracer_tpu.utils import checkpoint as JC

import haskell_path_tracer_torch as hpt
from haskell_path_tracer_torch.diff import grad as G
from haskell_path_tracer_torch.ops.rng import gen_seeds
from haskell_path_tracer_torch.utils import checkpoint as C

torch.set_num_threads(2)


def _params():
    return G.scene_to_params(hpt.main_scene("cpu"))


def _assert_params_equal(a, b):
    assert len(a) == len(b) == len(G.SceneParams._fields)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_training_state_roundtrip(tmp_path):
    """The JAX package's tests/test_app.py round trip, through the port."""
    params = _params()
    opt_state = {"m": torch.zeros(3), "v": torch.ones(3)}
    path = str(tmp_path / "train.npz")
    C.save_training_state(path, params, opt_state, step=42)
    for like in (None, opt_state):
        p2, o2, step = C.load_training_state(path, params, like)
        assert step == 42 and isinstance(p2, G.SceneParams)
        _assert_params_equal(params, p2)
        assert sorted(o2) == ["m", "v"]
        assert torch.equal(o2["v"], opt_state["v"]) and torch.equal(o2["m"], opt_state["m"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_training_state_loads_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / "train.npz")
    jparams = JG.scene_to_params(J.main_scene())
    jopt = {"v": jnp.arange(4.0), "m": (jnp.ones(2), jnp.int32(7)), "lr": 0.25}
    params = _params()
    opt = {"v": torch.arange(4.0), "m": (torch.ones(2), torch.tensor(7, dtype=torch.int32)),
           "lr": 0.25}
    if writer == "jax":
        JC.save_training_state(path, jparams, jopt, step=9)
        p2, o2, step = C.load_training_state(path, params, opt)
    else:
        C.save_training_state(path, params, opt, step=9)
        p2, o2, step = JC.load_training_state(path, jparams, jopt)
    assert step == 9
    _assert_params_equal(p2, jparams)
    _assert_params_equal(params, jparams)
    np.testing.assert_array_equal(np.asarray(o2["v"]), np.arange(4.0, dtype=np.float32))
    np.testing.assert_array_equal(np.asarray(o2["m"][0]), np.ones(2, np.float32))
    assert int(o2["m"][1]) == 7 and float(o2["lr"]) == 0.25


def _loss_grad(leaves):
    """The inverse-rendering gradient at 8x8 / 2 bounces, set on `leaves`."""
    scene = hpt.main_scene("cpu")
    cam = hpt.initial_camera("cpu")
    rng = gen_seeds((8, 8), 3, "cpu")
    target = torch.full((8, 8, 3), 0.3)
    _, grads = G.loss_and_grad(G.SceneParams(*leaves), scene, cam, target, rng, num_bounces=2)
    for leaf, g in zip(leaves, grads):
        leaf.grad = g.clone()


OPTIMIZERS = {
    "sgd": lambda p: torch.optim.SGD(p, lr=1e-2),
    "sgd_momentum": lambda p: torch.optim.SGD(p, lr=1e-2, momentum=0.9, nesterov=True),
    "adam": lambda p: torch.optim.Adam(p, lr=1e-3, betas=(0.8, 0.99)),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_resume_is_bit_identical(tmp_path, name):
    """Two steps, save, load into a new optimizer, one step: equal, bit for
    bit, to three steps straight."""
    make = OPTIMIZERS[name]

    def run(leaves, opt, steps):
        for _ in range(steps):
            opt.zero_grad()
            _loss_grad(leaves)
            opt.step()

    straight = [t.clone().requires_grad_() for t in _params()]
    run(straight, make(straight), 3)

    leaves = [t.clone().requires_grad_() for t in _params()]
    opt = make(leaves)
    run(leaves, opt, 2)
    path = str(tmp_path / "train.npz")
    C.save_training_state(path, G.SceneParams(*leaves), opt.state_dict(), step=2)
    del leaves, opt
    params, opt_state, step = C.load_training_state(path, _params())
    assert step == 2
    resumed = [t.clone().requires_grad_() for t in params]
    opt = make(resumed)
    opt.load_state_dict(opt_state)
    assert opt.state_dict()["param_groups"] == make(straight).state_dict()["param_groups"]
    run(resumed, opt, 1)
    for a, b in zip(resumed, straight):
        assert torch.equal(a, b)


class _Pair(NamedTuple):
    first: object
    second: object


def test_training_state_keeps_what_is_not_an_array(tmp_path):
    """Integer keys, tuples apart from lists, Python numbers by type,
    strings and None survive without a template."""
    path = str(tmp_path / "train.npz")
    opt_state = {"state": {1: {"step": torch.tensor(3.0)}, 0: {}},
                 "groups": [{"betas": (0.9, 0.99), "name": "fine", "fused": None,
                             "nesterov": True, "ids": [0, 1], "eps": 1e-8}],
                 "pair": _Pair(np.arange(3), 2)}
    C.save_training_state(path, _params(), opt_state, step=5)
    _, o2, _ = C.load_training_state(path, _params())
    assert list(o2["state"]) == [0, 1] and torch.equal(o2["state"][1]["step"], torch.tensor(3.0))
    assert o2["groups"] == [{"betas": (0.9, 0.99), "name": "fine", "fused": None,
                             "nesterov": True, "ids": [0, 1], "eps": 1e-8}]
    assert type(o2["groups"][0]["ids"][0]) is int and type(o2["groups"][0]["nesterov"]) is bool
    assert o2["pair"]._fields == ("first", "second") and o2["pair"].second == 2
    np.testing.assert_array_equal(o2["pair"].first, np.arange(3))
    # A JAX-written file has no structure: the optimizer state needs its
    # template there.
    JC.save_training_state(path, JG.scene_to_params(J.main_scene()), {"m": jnp.zeros(2)}, 1)
    with pytest.raises(ValueError, match="opt_state_like"):
        C.load_training_state(path, _params())


def test_training_state_overwrite_leaves_no_tmp(tmp_path):
    path = str(tmp_path / "train.npz")
    C.save_training_state(path, _params(), {"m": torch.zeros(2)}, step=1)
    C.save_training_state(path, _params(), {"m": torch.ones(2)}, step=2)
    _, o2, step = C.load_training_state(path, _params())
    assert step == 2 and torch.equal(o2["m"], torch.ones(2))
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
