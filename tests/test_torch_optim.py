"""Port parity for the optimizers (`laudnet_tpu_torch/train/optim.py`:
``torch.optim`` over backbone and masker groups) against
`laudnet_tpu/train/optim.py` (optax): three steps of SGD and of RMSprop on
a small parameter tree that has both groups, a frozen T2T performer ``w``,
norm parameters and a rank-3 token, with the same random gradients and a
changing learning rate. Parameters after every step agree to rtol 1e-6,
atol 1e-7 (f32 on both sides); step 2 and 3 show the momentum.

The trees are carried across by `convert/from_jax.py`: `to_flax_tree` gives
the flax layout of the port's parameters and `load_flax_variables` turns a
flax-layout gradient tree into the port's layout."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from laudnet_tpu.train import optim as jo
from laudnet_tpu_torch.convert.from_jax import (load_flax_variables,
                                                to_flax_tree)
from laudnet_tpu_torch.train import optim as to

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-7)
LRS = (0.05, 0.04, 0.01)


class _Performer(nn.Module):
    def __init__(self):
        super().__init__()
        self.kqv = nn.Linear(4, 6)
        self.w = nn.Parameter(torch.empty(3, 2), requires_grad=False)


class _Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn1 = _Performer()


class _Tiny(nn.Module):
    """Names as the ViT's: a body Linear, a LayerNorm, a policy head, a
    T2T stem with a fixed ``w``, and the rank-3 class token."""

    def __init__(self, seed):
        super().__init__()
        self.qkv = nn.Linear(4, 3)
        self.norm1 = nn.LayerNorm(3)
        self.token_policy = nn.Linear(3, 2)
        self.t2t_stem = _Stem()
        self.cls_token = nn.Parameter(torch.empty(1, 1, 3))
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.randn(p.shape, generator=g))


def _grad_trees(tree, seed, steps=3):
    """Random gradients in the flax layout, one tree a step; the frozen
    ``w`` gets zeros, as ``stop_gradient`` gives it."""
    rng = np.random.default_rng(seed)

    def rand(path, leaf):
        if jo.is_frozen_path(path):
            return np.zeros_like(leaf)
        # small second-moment values stress the RMSprop epsilon's place
        return (rng.standard_normal(leaf.shape) * 1e-3).astype(np.float32)

    return [jax.tree_util.tree_map_with_path(rand, tree)
            for _ in range(steps)]


def _run_both(make_j, make_t, seed):
    model = _Tiny(seed)
    params = to_flax_tree(model)
    w0 = model.t2t_stem.attn1.w.clone()
    jopt = make_j(params)
    jstate = jopt.init(params)
    topt = make_t(model)
    assert all(p is not model.t2t_stem.attn1.w
               for g in topt.param_groups for p in g["params"])
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    for lr, grads in zip(LRS, _grad_trees(params, seed)):
        jstate.hyperparams["learning_rate"] = jnp.float32(lr)
        updates, jstate = jopt.update(
            jax.tree_util.tree_map(jnp.asarray, grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        gmodel = load_flax_variables(copy.deepcopy(model), grads)
        for p, gp in zip(model.parameters(), gmodel.parameters()):
            if p.requires_grad:
                p.grad = gp.detach().clone()
        to.set_learning_rate(topt, lr)
        topt.step()
        got = to_flax_tree(model)
        flat_ref = jax.tree_util.tree_leaves_with_path(jparams)
        flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_ref) == len(flat_got) == 10
        for path, ref in flat_ref:
            np.testing.assert_allclose(flat_got[path], np.asarray(ref),
                                       **TOL, err_msg=str(path))
    assert torch.equal(model.t2t_stem.attn1.w, w0)      # never decayed
    return model, topt


@pytest.mark.parametrize("kw", [
    dict(), dict(nesterov=False, momentum=0.8),
    dict(backbone_lr_mult=0.1, masker_lr_mult=2.0, weight_decay=1e-2),
    dict(decay_weights_only=True, weight_decay=1e-2)],
    ids=["default", "heavy_ball", "group_multipliers", "decay_weights_only"])
def test_sgd_matches_optax(kw):
    _, opt = _run_both(lambda p: jo.make_sgd(p, **kw),
                       lambda m: to.make_sgd(m, **kw), seed=len(kw))
    names = sorted(g["name"] for g in opt.param_groups)
    if kw.get("decay_weights_only"):
        assert names == ["backbone", "backbone_no_decay", "masker",
                         "masker_no_decay"]
        by = {g["name"]: g for g in opt.param_groups}
        assert by["backbone_no_decay"]["weight_decay"] == 0.0
        # biases, norm scale and bias, and the class token are exempt
        assert len(by["backbone_no_decay"]["params"]) == 5
        assert len(by["backbone"]["params"]) == 2
    else:
        assert names == ["backbone", "masker"]


@pytest.mark.parametrize("kw", [
    dict(), dict(backbone_lr_mult=0.5, weight_decay=1e-3, momentum=0.5)],
    ids=["default", "group_multipliers"])
def test_rmsprop_matches_optax(kw):
    """alpha 0.9, eps OUTSIDE the square root, momentum after the rescale:
    the gradients here are ~1e-3, where the other epsilon placement moves
    the step by far more than the tolerance."""
    _run_both(lambda p: jo.make_rmsprop(p, **kw),
              lambda m: to.make_rmsprop(m, **kw), seed=3 + len(kw))


def test_groups_follow_the_names():
    assert to.is_masker_path("blocks.0.token_policy.weight")
    assert to.is_masker_path("layer1.0.masker.conv.weight")
    assert not to.is_masker_path("blocks.0.qkv.weight")
    assert to.is_frozen_path("t2t_stem.attn2.w")
    assert not to.is_frozen_path("blocks.0.w")           # no T2T scope
    assert not to.is_frozen_path("t2t_stem.attn2.kqv.weight")
    opt = to.make_sgd(_Tiny(0), backbone_lr_mult=0.1)
    to.set_learning_rate(opt, 0.5)
    rates = {g["name"]: g["lr"] for g in opt.param_groups}
    assert rates == {"backbone": pytest.approx(0.05), "masker": 0.5}
