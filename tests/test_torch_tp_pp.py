"""The port's FSDP over a TP layout and its pipeline on four gloo ranks on
the CPU: a (2 data, 2 model) mesh and a (2 data, 2 stage) mesh, spawned
once for the whole file (`quad`, scenarios in
`tests/_torch_parallel_worker.py`).

* FSDP over TP: the gradients of the global loss equal JAX's (rtol 2e-4,
  atol 2e-5, as `tests/test_torch_parallel.py`);
* `pipeline_apply` against the sequential trunk of the same blocks, the
  port's own (forward 1e-5; gradients, which sum microbatches in another
  order, rtol 1e-4 / atol 1e-6);
* `pp_vit_forward` at eval against JAX's `pp_vit_forward` on 2 virtual
  devices: logits rtol 2e-4 / atol 2e-5, densities exact in f32 up to
  1e-6, `flops_perc` and `flops` rtol 2e-5 (JAX's own pp test);
* the pipelined train step in f32 against JAX's `make_pp_train_step` on 2
  virtual devices and against the port's one-process step, each on the same
  noise and batch (metrics rtol 1e-4, updated parameters rtol 1e-4 / atol
  1e-5, as the data-parallel step in `tests/test_torch_parallel.py`); under
  bf16 compute (``--amp``), which the JAX package's
  pipeline does not honour (its head stays f32, `tests/test_tp_pp.py::
  test_pp_vit_forward_honors_amp_dtype`), against the port's own one-process
  bf16 step: metrics rtol 2e-2, parameters atol 2e-3 (a bf16 rounding of
  the activations moves an update by at most that).
"""


import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
from test_torch_parallel import (JVIT, _as_flax_grads, _assert_trees,
                                 _record_numpy_gumbel,
                                 _jax_logits_and_grads, load, spawn)
from laudnet_tpu.models import laud_vit as jlv
from laudnet_tpu.parallel import make_pp_mesh as jmake_pp_mesh
from laudnet_tpu.parallel import make_pp_train_step as jmake_pp_train_step
from laudnet_tpu.parallel import pp_vit_forward as jpp_vit_forward
from laudnet_tpu.train import optim as jo
from laudnet_tpu.train import trainer as jt
from laudnet_tpu_torch.convert.from_jax import to_flax_tree
from laudnet_tpu_torch.ops.gating import ReplayNoise
from laudnet_tpu_torch.parallel import pipeline_apply, stack_layer_params
from laudnet_tpu_torch.train import optim
from laudnet_tpu_torch.train import trainer as tt

torch.set_num_threads(1)


def _jax_pp_step():
    """JAX's pipelined train step (2 stages, 2 microbatches of 4 rows, on 2
    virtual devices) on the 8 rows the ranks train on, with the layer and
    head gates' noise drawn from numpy: its metrics, updated parameters and
    the draws, one per gate of a stage's block position (the pipeline
    traces its stage once inside a scan, so every stage, microbatch and
    tick reuses them)."""
    geom = dict(JVIT, depth=4)
    model = W.vit_model(4, W.PP_VIT, token_skip=False)
    teacher = W.vit_model(5, W.PP_VIT, token_skip=False, head_skip=False,
                          layer_skip=False)
    params = to_flax_tree(model)
    jmodel = jlv.LAUDViT(**geom, token_skip=False)
    jopt = jo.make_sgd(params, weight_decay=1e-3)
    state = jt.create_train_state(jmodel, jopt, None, rng=None,
                                  variables={"params": params})
    step = jax.jit(jmake_pp_train_step(
        jmodel, jlv.LAUDViT(**geom, token_skip=False, head_skip=False,
                            layer_skip=False),
        {"params": to_flax_tree(teacher)}, jopt,
        jt.TrainConfig(full_flops=1e7, **W.TRAIN),
        mesh=jmake_pp_mesh(2, n_devices=2), microbatches=2))
    (state, m), drawn = _record_numpy_gumbel(lambda: step(
        state, jnp.asarray(W.images(12, b=8).numpy()),
        jnp.asarray(np.arange(8) % 12, jnp.int32), jax.random.PRNGKey(7)))
    # per block position of a stage: the layer gate's, then the heads'
    assert [a.shape for a in drawn] == [(4, 2, 2), (4, 2, 4)] * 2
    return {k: float(v) for k, v in m.items()}, state.params, drawn


@pytest.fixture(scope="module")
def quad(tmp_path_factory):
    """JAX's pipelined step (its noise saved for the ranks), then the four
    ranks."""
    d = str(tmp_path_factory.mktemp("quad"))
    metrics, params, drawn = _jax_pp_step()
    np.savez(os.path.join(d, "noise_pp.npz"),
             **{str(i): a for i, a in enumerate(drawn)})
    spawn("quad", 4, d)
    return d, metrics, params


def test_fsdp_over_tp_base_matches_jax(quad):
    """dp2 x tp2: the TP layout splits the heads and hidden units, FSDP the
    largest dim the TP layout leaves free over the data ranks; the
    gradients of the global loss are JAX's."""
    quad, _, _ = quad
    x = W.images(7).numpy()
    model, jout, jgrads = _jax_logits_and_grads(x, np.arange(4) % 12)
    for rank in range(4):
        r = load(quad, "fsdp2", rank)
        d = rank // 2
        np.testing.assert_allclose(
            r["logits"].numpy(), np.asarray(jout.logits)[2 * d:2 * d + 2],
            rtol=2e-4, atol=2e-5)
        # qkv: TP on dim 0 (heads), FSDP on dim 1, the one left
        assert r["specs"]["blocks.0.qkv.weight"] == "S(1)"
        _assert_trees(_as_flax_grads(model, r["grads"]), jgrads, 2e-4, 2e-5,
                      "fsdp over tp grad")


def _sequential(tokens):
    model = W.vit_model(4, W.PP_VIT, token_skip=False)
    x = tokens.clone().requires_grad_()
    y, m = x, torch.ones(tokens.shape[:2])
    for blk in model.blocks:
        y, m, _ = blk(y, m, 0.1, book_len=5)
    (y ** 2).mean().backward()
    return model, y.detach(), x.grad


def test_pipeline_apply_matches_the_sequential_trunk(quad):
    """2 stages of 2 layers, 2 microbatches of 2 rows on each of 2 data
    shards: the output on every rank, each stage's layers' gradients and
    the input's gradient equal the sequential trunk's on the global batch
    (each data shard's loss is the mean over its rows, so a shard's
    gradients are twice its share of the global mean's)."""
    quad, _, _ = quad
    tokens = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (8, 5, 64)).astype(np.float32))
    model, y, dx = _sequential(tokens)
    ref_grads = {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None and n.startswith("blocks.")}
    got_grads = {}
    for rank in range(4):
        r = load(quad, "pipeline", rank)
        assert r["n"] == 4
        d = rank // 2
        rows = slice(4 * d, 4 * d + 4)
        np.testing.assert_allclose(r["out"].numpy(), y[rows].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["dx"].numpy() / 2, dx[rows].numpy(),
                                   rtol=1e-4, atol=1e-7)
        for name, g in r["grads"].items():
            got_grads[name] = got_grads.get(name, 0) + g / 2
    assert sorted(got_grads) == sorted(ref_grads)
    for name, g in ref_grads.items():
        np.testing.assert_allclose(got_grads[name].numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_pipeline_apply_refuses_an_indivisible_batch():
    with pytest.raises(ValueError, match="not divisible into 3"):
        pipeline_apply(lambda p, x: x, None, torch.zeros(4, 2), mesh=None,
                       microbatches=3)
    layers, n = stack_layer_params({"block_1": "b", "block_0": "a",
                                    "norm": "c"})
    assert (layers, n) == (["a", "b"], 2)
    with pytest.raises(ValueError, match="no 'block_"):
        stack_layer_params({})


def test_pp_vit_forward_at_eval_matches_jax(quad):
    """The whole model with its trunk in 2 stages x 2 microbatches over 2
    data shards, against JAX's `pp_vit_forward` on 2 virtual devices (its
    own 2 stages): logits, per-block densities, flops_perc and flops."""
    quad, _, _ = quad
    model = W.vit_model(4, W.PP_VIT)
    jmodel = jlv.LAUDViT(**dict(JVIT, depth=4))
    x = W.images(10, b=8).numpy()
    ref = jax.jit(lambda p, xx: jpp_vit_forward(
        jmodel, p, xx, 0.1, mesh=jmake_pp_mesh(2, n_devices=2),
        microbatches=4))(to_flax_tree(model), jnp.asarray(x))
    for rank in range(4):
        r = load(quad, "pp_forward", rank)
        d = rank // 2
        np.testing.assert_allclose(
            r["logits"].numpy(), np.asarray(ref.logits)[4 * d:4 * d + 4],
            rtol=2e-4, atol=2e-5)
        for k in ("token_density", "head_density", "attn_density",
                  "mlp_density"):
            np.testing.assert_allclose(r[k].numpy(), np.asarray(
                getattr(ref, k)), rtol=1e-6, atol=1e-6, err_msg=k)
        assert float(r["head_density"].min()) < 1.0   # gates closed heads
        np.testing.assert_allclose(r["flops_perc"].numpy(), np.asarray(
            ref.flops_perc), rtol=2e-5, atol=1e-6)
        np.testing.assert_allclose(float(r["flops"]), float(ref.flops),
                                   rtol=2e-5)
        np.testing.assert_allclose(
            r["token_keep"].numpy(),
            np.asarray(ref.token_keep)[:, 4 * d:4 * d + 4], atol=1e-6)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_pp_train_step_matches_the_one_process_step(quad, amp):
    """The pipelined train step (2 data shards x 2 stages, 2 microbatches)
    against the one-process step on the 8 rows with the same noise (head
    and layer gates, `_torch_parallel_worker.pp_noise`): every metric and
    every updated parameter."""
    quad, _, _ = quad
    cd = torch.bfloat16 if amp else None
    model = W.vit_model(4, W.PP_VIT, token_skip=False, compute_dtype=cd)
    teacher = W.vit_model(5, W.PP_VIT, token_skip=False, head_skip=False,
                          layer_skip=False, compute_dtype=cd)
    teacher.requires_grad_(False)
    noise = W.pp_noise(quad)
    opt = optim.make_sgd(model, weight_decay=1e-3)
    step = tt.make_train_step(
        model, teacher, opt, tt.TrainConfig(full_flops=1e7, **W.TRAIN),
        noise=ReplayNoise([a for block in noise for a in block]))
    m = step(tt.TrainState(step=0, model=model, optimizer=opt),
             W.images(12, b=8), torch.arange(8) % 12)
    assert float(m["act_rate"]) < 1.0
    rtol, atol = (2e-2, 2e-3) if amp else (1e-4, 1e-5)
    for rank in range(4):
        r = load(quad, "pp_train_amp" if amp else "pp_train", rank)
        for k, v in m.items():
            np.testing.assert_allclose(r["metrics"][k], float(v), rtol=rtol,
                                       atol=1e-6, err_msg=k)
        _assert_trees(r["params"], to_flax_tree(model), rtol, atol,
                      "params")


def test_pp_train_step_matches_jax(quad):
    """The pipelined f32 train step (2 data shards x 2 stages, 2
    microbatches, the sparsity loss on the whole batch's densities) against
    JAX's `make_pp_train_step` on the same 8 rows and noise: every metric
    JAX reports and every updated parameter."""
    quad, metrics, params = quad
    for rank in range(4):
        r = load(quad, "pp_train", rank)
        assert metrics["act_rate"] < 1.0
        for k, v in metrics.items():
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        _assert_trees(r["params"], params, 1e-4, 1e-5, "params")
