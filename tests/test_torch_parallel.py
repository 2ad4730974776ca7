"""The port's `parallel/` on two gloo ranks on the CPU, against the JAX
package's single program over a sharded batch (`tests/test_parallel.py`,
`tests/test_tp_pp.py`, `tests/test_tp_fused.py` on its side).

The two ranks are spawned once for the whole file (`pair`): each runs every
scenario of `tests/_torch_parallel_worker.py` and saves its results; the
tests compare those with JAX, run here. Tolerances:

* data parallelism (the train step with the global batch's gate densities
  and BatchNorm statistics) is held as the one-process step is in
  `tests/test_torch_trainer.py`: metrics rtol 1e-4, the updated parameters
  and statistics rtol 1e-4 with atol 1e-5 (the all-reduces add in another
  order than one program's sums);
* tensor, sequence and FSDP parallelism, forward and gradients: f32 sums
  split over ranks, rtol 2e-4 / atol 2e-5 (JAX's own TP test's 2e-4);
* the attention on local heads: 1e-5, as the unsharded fused attention is
  held to JAX (`tests/test_torch_vit_attention.py`).

The sparse execution, the quantised products and a grouped conv2 under
tensor parallelism are held to JAX's UNSHARDED model (GSPMD runs a sharded
JAX model with its unsharded semantics) at the TP tolerance, 2e-4 / 2e-5;
the int8 forms at seeds whose codes have no rounding tie (a code that
flips between frameworks moves logits by 1e-3 to 3e-2,
`tests/test_torch_quant.py`).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import _torch_parallel_worker as W
from laudnet_tpu.models import laud_resnet as jlr
from laudnet_tpu.models import laud_vit as jlv
from laudnet_tpu.models import resnet as jr
from laudnet_tpu.parallel import fsdp as jfsdp
from laudnet_tpu.parallel import tp as jtp
from laudnet_tpu.train import optim as jo
from laudnet_tpu.train import trainer as jt
from laudnet_tpu_torch.convert.from_jax import (_port_name,
                                                to_flax_batch_stats,
                                                to_flax_tree)
from laudnet_tpu_torch.models.laud_vit import vit_dense_flops
from laudnet_tpu_torch.parallel import (RESNET_TP_RULES, VIT_TP_RULES,
                                        fsdp_specs, tensor_parallel_specs)
from laudnet_tpu_torch.parallel.mesh import free_port
from laudnet_tpu_torch.parallel.tp import (ModelParallel,
                                           tp_fused_vit_attention)
from laudnet_tpu_torch.utils.flops import resnet_full_flops

torch.set_num_threads(1)
HERE = os.path.dirname(os.path.abspath(__file__))
JVIT = dict(depth=2, dim=64, num_heads=4, patch_size=16, num_classes=12,
            mlp_ratio=2.0)


def spawn(name: str, world: int, d: str, timeout: float = 240):
    """Runs the worker set ``name`` on ``world`` gloo ranks; raises with
    their output if one fails."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.dirname(HERE))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_parallel_worker.py"),
         name, str(r), str(world), str(port), d], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"


def load(d, name, rank):
    return torch.load(os.path.join(d, f"{name}_{rank}.pt"),
                      weights_only=False)


def _record_numpy_gumbel(fn):
    """Runs ``fn()`` with ``jax.random.gumbel`` drawing numpy noise (which
    a jitted step bakes in); returns its result and the draws in order."""
    drawn, rng = [], np.random.default_rng(11)
    original = jax.random.gumbel

    def numpy_gumbel(key, shape=(), dtype=float, **kw):
        drawn.append(rng.gumbel(size=shape).astype(np.float32))
        return jnp.asarray(drawn[-1])

    jax.random.gumbel = numpy_gumbel
    try:
        return fn(), drawn
    finally:
        jax.random.gumbel = original


def _jax_step(jmodel, jteacher, variables, tvariables, cfg, x, labels):
    jopt = jo.make_sgd(variables["params"], weight_decay=1e-3)
    state = jt.create_train_state(jmodel, jopt, None, rng=None,
                                  variables=variables)
    step = jax.jit(jt.make_train_step(jmodel, jteacher, tvariables, jopt,
                                      cfg))
    state, m = step(state, jnp.asarray(x), jnp.asarray(labels),
                    jax.random.PRNGKey(7))
    return state, {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """JAX's data-parallel reference steps (their noise saved for the
    ranks), then the two ranks."""
    d = str(tmp_path_factory.mktemp("pair"))
    labels = np.random.default_rng(6).integers(0, 10, (4,)).astype(np.int32)
    ref = {}
    # the ViT: head and layer gates
    model = W.vit_model(0, token_skip=False)
    teacher = W.vit_model(2, token_skip=False, head_skip=False,
                          layer_skip=False)
    full = vit_dense_flops(model, input_size=32)
    ref["vit"], noise = _record_numpy_gumbel(lambda: _jax_step(
        jlv.LAUDViT(**JVIT, token_skip=False),
        jlv.LAUDViT(**JVIT, token_skip=False, head_skip=False,
                    layer_skip=False),
        {"params": to_flax_tree(model)}, {"params": to_flax_tree(teacher)},
        jt.TrainConfig(full_flops=full, **W.TRAIN),
        W.images(5).numpy(), labels))
    np.savez(os.path.join(d, "noise_vit.npz"), full_flops=full,
             **{str(i): a for i, a in enumerate(noise)})
    # the CNN: every masker, BatchNorm in training
    model, teacher = W.cnn_model(0)
    full = resnet_full_flops((1, 1, 1, 1), 64, 0.25, 10)
    jkw = {k: v for k, v in W.CNN_KW.items()}
    ref["cnn"], noise = _record_numpy_gumbel(lambda: _jax_step(
        jlr.LAUDResNet(**jkw),
        jr.ResNet(layers=(1, 1, 1, 1), num_classes=10, width_mult=0.25),
        {"params": to_flax_tree(model),
         "batch_stats": to_flax_batch_stats(model)},
        {"params": to_flax_tree(teacher),
         "batch_stats": to_flax_batch_stats(teacher)},
        jt.TrainConfig(full_flops=full, sparsity_criterion="cs",
                       dyn_mode=W.CNN_KW["dyn_mode"], **W.TRAIN),
        W.images(4, size=64).numpy(), labels))
    np.savez(os.path.join(d, "noise_cnn.npz"), full_flops=full,
             **{str(i): a for i, a in enumerate(noise)})
    rng = np.random.default_rng(3)
    np.savez(os.path.join(d, "attention.npz"),
             qkv=rng.standard_normal((2, 7, 3 * 96)).astype(np.float32),
             key_mask=(rng.random((2, 7)) > 0.3).astype(np.float32),
             head_mask=(rng.random((2, 6)) > 0.4).astype(np.float32),
             g=rng.standard_normal((2, 7, 96)).astype(np.float32))
    spawn("pair", 2, d)
    return d, ref


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _assert_trees(got, ref, rtol, atol, what):
    got = _leaves(got)
    ref = jax.tree_util.tree_leaves_with_path(ref)
    assert len(ref) == len(got) > 0
    for path, leaf in ref:
        np.testing.assert_allclose(np.asarray(got[path]), np.asarray(leaf),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} {path}")


@pytest.mark.parametrize("kind", ["vit", "cnn"])
def test_dp_step_matches_jax_single_program(pair, kind):
    """One train step on 2 ranks x 2 rows against JAX's one program on the
    4 rows: the ViT's sparsity loss on the global densities, the CNN's
    BatchNorm on the global batch statistics (SyncBatchNorm semantics)."""
    d, ref = pair
    state, jmetrics = ref[kind]
    r0, r1 = load(d, f"dp_{kind}", 0), load(d, f"dp_{kind}", 1)
    for k, v in jmetrics.items():
        for r in (r0, r1):
            np.testing.assert_allclose(r["metrics"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    assert jmetrics["act_rate"] < 1.0          # the gates closed something
    _assert_trees(r0["params"], state.params, 1e-4, 1e-5, "params")
    for a, b in zip(jax.tree_util.tree_leaves(r0["params"]),
                    jax.tree_util.tree_leaves(r1["params"])):
        np.testing.assert_array_equal(a, b)    # the ranks stay replicated
    if kind == "cnn":
        _assert_trees(r0["batch_stats"], state.batch_stats, 1e-4, 1e-5,
                      "batch_stats")


def _jax_logits_and_grads(x, labels, seed=1):
    """JAX's unsharded forward at eval gates and the gradients of
    `vit_loss` on the model of ``W.vit_model(seed)``."""
    model = W.vit_model(seed)
    jmodel = jlv.LAUDViT(**JVIT)
    params = to_flax_tree(model)

    def loss(p):
        out = jmodel.apply({"params": p}, x, 0.1, training=False)
        ce = -jax.nn.log_softmax(out.logits)[jnp.arange(len(labels)),
                                             labels].mean()
        return ce + (out.flops_perc.mean() - 0.5) ** 2, out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    return model, out, grads


def _as_flax_grads(model, grads):
    """Port gradients by name (single-device layout) as a flax tree."""
    for name, p in model.named_parameters():
        p.grad = grads.get(name)
    return to_flax_tree(model, grads=True)


@pytest.mark.parametrize("name", ["tp", "sp"])
def test_tp_and_sp_forward_and_grads_match_jax(pair, name):
    """Megatron TP over 2 ranks (qkv by heads, proj/fc2 row-parallel, the
    class head column-parallel), and with sequence parallelism (the stream
    token-sharded at each block boundary: 3 of the 5 tokens a rank, the
    last padded): the logits and every gradient equal JAX's unsharded
    ones."""
    d, _ = pair
    x = W.images(7).numpy()
    labels = np.arange(4) % 12
    model, jout, jgrads = _jax_logits_and_grads(x, labels)
    for rank in (0, 1):
        r = load(d, name, rank)
        assert r["qkv_local"] == (96, 64)      # half the heads' q, k, v
        assert r["sharded_tokens"] == ([3, 3] if name == "sp" else [])
        np.testing.assert_allclose(r["logits"].numpy(), np.asarray(
            jout.logits), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["flops_perc"].numpy(), np.asarray(
            jout.flops_perc), rtol=1e-5)
        _assert_trees(_as_flax_grads(model, r["grads"]), jgrads, 2e-4, 2e-5,
                      f"{name} grad")


def _zero_gumbel(fn):
    """Runs ``fn()`` with ``jax.random.gumbel`` drawing zeros (the port's
    `W.ZeroNoise`)."""
    original = jax.random.gumbel
    jax.random.gumbel = lambda key, shape=(), dtype=float, **kw: jnp.zeros(
        shape, dtype)
    try:
        return fn()
    finally:
        jax.random.gumbel = original


def _jax_loss_and_grads(jmodel, model, x, labels, training=False):
    """JAX's unsharded logits and the gradients of `W.vit_loss` on the
    weights (and BatchNorm statistics) of the port's ``model``; training
    at zero Gumbel noise."""
    variables = {"params": to_flax_tree(model)}
    if any(True for _ in model.buffers()):
        variables["batch_stats"] = to_flax_batch_stats(model)

    def loss(p):
        v = dict(variables, params=p)
        if training:
            out, _ = jmodel.apply(v, x, 0.1, training=True,
                                  mutable=["batch_stats"],
                                  rngs={"gumbel": jax.random.PRNGKey(0)})
        else:
            out = jmodel.apply(v, x, 0.1, training=False)
        ce = -jax.nn.log_softmax(out.logits)[jnp.arange(len(labels)),
                                             labels].mean()
        return ce + (out.flops_perc.mean() - 0.5) ** 2, out

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    (_, out), grads = _zero_gumbel(lambda: step(variables["params"]))
    return out, grads, variables


def test_tp_sparse_execution_matches_jax(pair):
    """The flagship's form in sparse execution over 2 ranks: conv2
    column-parallel on the gathered patches, conv3 row-parallel with its
    partial sums reduced before bn3 and the scatter-add. The logits and
    ``flops_perc`` equal JAX's unsharded sparse model's (a sparse branch
    that scatters one rank's partial instead is 0.68 of the largest logit
    off here)."""
    d, _ = pair
    x = W.images(4, size=64)
    model = W.half_open_cnn(0, x, execution="sparse")
    jmodel = jlr.LAUDResNet(**W.FLAGSHIP_FORM, execution="sparse")
    v = {"params": to_flax_tree(model),
         "batch_stats": to_flax_batch_stats(model)}
    ref = jax.jit(lambda v, x: jmodel.apply(v, x, 0.1, training=False))(
        v, jnp.asarray(x.numpy()))
    kept = float(np.asarray(ref.spatial_s3[0]).mean())
    assert 0.25 < kept < 0.75, kept   # the sparse block gathers some cells
    for rank in (0, 1):
        r = load(d, "tp_sparse", rank)
        assert r["conv3_local"] == (64, 8, 1, 1)   # half of conv3's input
        np.testing.assert_allclose(r["logits"].numpy(), np.asarray(
            ref.logits), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["flops_perc"].numpy(), np.asarray(
            ref.flops_perc), rtol=1e-5)


@pytest.mark.parametrize("kind", ["vit", "cnn"])
def test_tp_quantised_products_match_jax(pair, kind):
    """``linear_impl`` / ``conv_impl='int8_qat'`` over 2 ranks, the
    row-parallel products' scales taken over the whole input dim: the eval
    logits (W8A8, the integer partials summed exactly) equal JAX's
    unsharded int8 model's, and a training forward at zero noise
    (fake-quant) gives JAX's logits and every gradient."""
    d, _ = pair
    seed, image_seed = W.QUANT_SEEDS[kind]
    if kind == "vit":
        model = W.vit_model(seed, token_skip=False, linear_impl="int8_qat")
        jmodel = lambda impl: jlv.LAUDViT(**JVIT, token_skip=False,
                                          linear_impl=impl)
        x, labels = W.images(image_seed).numpy(), np.arange(4) % 12
    else:
        model = W.laud_cnn(seed, conv_impl="int8_qat")
        jmodel = lambda impl: jlr.LAUDResNet(**W.CNN_KW, conv_impl=impl)
        x, labels = W.images(image_seed, size=64).numpy(), np.arange(4) % 10
    out, grads, v = _jax_loss_and_grads(jmodel("int8_qat"), model, x,
                                        labels, training=True)
    served = jax.jit(lambda v, x: jmodel("int8").apply(
        v, x, 0.1, training=False))(v, jnp.asarray(x))
    for rank in (0, 1):
        r = load(d, f"tp_quant_{kind}", rank)
        # half of the row-parallel fc2's / conv3's input
        assert r["row_local"] == {"vit": (64, 64),
                                  "cnn": (64, 8, 1, 1)}[kind]
        np.testing.assert_allclose(r["served"].numpy(), np.asarray(
            served.logits), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["logits"].numpy(), np.asarray(
            out.logits), rtol=2e-4, atol=2e-5)
        _assert_trees(_as_flax_grads(model, r["grads"]), grads, 2e-4, 2e-5,
                      f"{kind} int8_qat grad")


def test_tp_grouped_conv2_matches_jax(pair):
    """``group_width=2`` over 2 ranks: conv2 split by whole groups (one a
    rank, its input channels scattered), bn2 and conv3 following: the eval
    logits and every gradient equal JAX's unsharded model's."""
    d, _ = pair
    model = W.laud_cnn(0, group_width=2)
    out, grads, _ = _jax_loss_and_grads(
        jlr.LAUDResNet(**W.CNN_KW, group_width=2), model,
        W.images(4, size=64).numpy(), np.arange(4) % 10)
    for rank in (0, 1):
        r = load(d, "tp_grouped", rank)
        assert r["conv2"] == ((16, 16, 3, 3), 1)   # one whole group
        np.testing.assert_allclose(r["logits"].numpy(), np.asarray(
            out.logits), rtol=2e-4, atol=2e-5)
        _assert_trees(_as_flax_grads(model, r["grads"]), grads, 2e-4, 2e-5,
                      "grouped grad")


def test_tp_with_indivisible_heads_keeps_the_fused_attention(pair):
    """The CLI's layout at ``--tp 2`` of a ViT with 3 heads: qkv and proj
    stay replicated and the fused attention runs all 3 heads on each rank
    (no fall-back to the plain attention), fc1/fc2 and the head are split,
    and the logits equal the unsharded fused model's (f32 sums split over
    ranks: rtol 2e-4 / atol 2e-5)."""
    d, _ = pair
    ref = W.vit_model(1, W.INDIVISIBLE, attn_impl="fused")
    with torch.no_grad():
        logits = ref(W.images(7), 0.1, training=False).logits
    for rank in (0, 1):
        r = load(d, "tp_indivisible", rank)
        assert r["calls"] == [3] * W.INDIVISIBLE["depth"]
        assert r["qkv_local"] == (144, 48) and r["fc1_local"] == (48, 48)
        assert any("does not divide 3 heads" in ln for ln in r["log"])
        np.testing.assert_allclose(r["logits"].numpy(), logits.numpy(),
                                   rtol=2e-4, atol=2e-5)


def test_fsdp_forward_and_grads_match_jax(pair):
    """FSDP over the 2 data ranks: every rank's logits rows and the
    gradients of the global loss (each parameter's largest divisible dim
    sharded, the small ones replicated)."""
    d, _ = pair
    x = W.images(7).numpy()
    labels = np.arange(4) % 12
    model, jout, jgrads = _jax_logits_and_grads(x, labels)
    for rank in (0, 1):
        r = load(d, "fsdp1", rank)
        np.testing.assert_allclose(
            r["logits"].numpy(), np.asarray(jout.logits)[2 * rank:
                                                         2 * rank + 2],
            rtol=2e-4, atol=2e-5)
        assert "blocks.0.qkv.weight" in r["sharded"]
        assert "blocks.0.norm1.weight" not in r["sharded"]
        _assert_trees(_as_flax_grads(model, r["grads"]), jgrads, 2e-4, 2e-5,
                      "fsdp grad")


def test_tp_fused_vit_attention_runs_local_heads(pair):
    """Each rank's 3 of 6 heads (an odd local count, no fake head) through
    the fused attention's registered op and its backward: the gathered
    outputs and gradients equal JAX's fused attention on all heads."""
    from laudnet_tpu.ops.pallas.vit_attention import (
        fused_vit_attention as jfused)

    d, _ = pair
    z = np.load(os.path.join(d, "attention.npz"))
    r = [load(d, "attention", rank) for rank in (0, 1)]

    def f(qkv, hm):
        return jfused(qkv, jnp.asarray(z["key_mask"]), hm, 6, 0.125,
                      interpret=True)

    out, vjp = jax.vjp(f, jnp.asarray(z["qkv"]), jnp.asarray(z["head_mask"]))
    dqkv, dhead = vjp(jnp.asarray(z["g"]))
    got = torch.cat([x["out"] for x in r], -1)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-5)
    # the qkv gradient per rank is its heads' q, k and v sections
    sections = [torch.stack(x["dqkv"].split(48, -1)) for x in r]
    got_dqkv = torch.cat(sections, -1)                 # (3, B, L, 96)
    ref_dqkv = np.stack(np.split(np.asarray(dqkv), 3, -1))
    np.testing.assert_allclose(got_dqkv.numpy(), ref_dqkv, rtol=1e-5,
                               atol=1e-5)
    for x in r:      # the head gate's gradient is whole on every rank
        np.testing.assert_allclose(x["dhead"].numpy(), np.asarray(dhead),
                                   rtol=1e-5, atol=1e-5)


def test_tp_fused_vit_attention_rejects_indivisible_heads():
    """T2T's 7 heads on 2 ranks: JAX's message, before any collective."""
    mp = ModelParallel(group=None, rank=0, size=2)
    qkv = torch.zeros(1, 4, 3 * 7 * 16)
    with pytest.raises(ValueError, match="num_heads=7 not divisible"):
        tp_fused_vit_attention(qkv, torch.ones(1, 4), None, 7, 0.25, mp)


def test_serving_engine_mesh_serves_the_first_rank_s_weights(pair):
    """`ServingEngine(mesh=)` on 2 ranks: the weights replicated from rank
    0 (rank 1 had changed its head), each rank serving its half of the
    batch, the logits gathered: equal to the engine without a mesh."""
    d, _ = pair
    r0, r1 = load(d, "serve", 0), load(d, "serve", 1)
    for r in (r0, r1):
        np.testing.assert_allclose(r["mesh"].numpy(), r0["alone"].numpy(),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(r1["alone"].numpy(), r0["alone"].numpy())


# --- the layouts, without ranks --------------------------------------------

# a kernel's dims in the port's layout: Linear (in, out) -> (out, in),
# conv HWIO -> OIHW (`convert/from_jax.py::_convert`)
KERNEL_DIMS = {2: (1, 0), 4: (2, 3, 1, 0)}


def _compare_specs(port_specs, jax_specs, jax_params, axis, skip=()):
    """Asserts that every leaf's ``axis`` dim is the same on both sides;
    returns how many leaves are split."""
    flat = jax.tree_util.tree_leaves_with_path(
        jax_specs, is_leaf=lambda s: isinstance(
            s, jax.sharding.PartitionSpec))
    shapes = _leaves(jax_params)
    n = 0
    for path, spec in flat:
        name, kind = _port_name(".".join(str(p.key) for p in path))
        if any(s in name for s in skip):
            continue
        want = tuple(spec).index(axis) if axis in tuple(spec) else None
        if kind == "kernel" and want is not None:
            want = KERNEL_DIMS[np.ndim(shapes[path])][want]
        got = port_specs[name]
        assert (got.dim if isinstance(got, Shard) else None) == want, (
            name, got, spec)
        n += isinstance(got, Shard)
    return n


def test_vit_tp_and_fsdp_specs_match_jax():
    """The port's TP layout of a LAUD-ViT, and FSDP over it, split the same
    dims as JAX's rules on the same geometry (names through
    `convert/from_jax.py`, kernels transposed)."""
    model = W.vit_model(1)
    params = to_flax_tree(model)
    tp = tensor_parallel_specs(model, VIT_TP_RULES)
    jspecs = jtp.tensor_parallel_specs(params, jtp.VIT_TP_RULES)
    assert _compare_specs(tp, jspecs, params, "model") == 2 * 6 + 2
    assert isinstance(tp["blocks.0.token_policy.weight"], Replicate)
    fs = fsdp_specs(model, min_size=1024, base_specs=tp)
    jfs = jfsdp.fsdp_specs(params, min_size=1024, base_specs=jspecs)
    assert _compare_specs(fs, jfs, params, "data") > 0


def test_resnet_tp_specs_match_jax_but_bn2():
    """RESNET_TP_RULES: conv2 on its output channels, conv3 on its input
    channels, the classifier column-parallel, as JAX's; the port also
    splits bn2 with conv2's channels (JAX keeps it replicated)."""
    model, _ = W.cnn_model(0)
    params = to_flax_tree(model)
    tp = tensor_parallel_specs(model, RESNET_TP_RULES)
    jspecs = jtp.tensor_parallel_specs(params, jtp.RESNET_TP_RULES)
    assert _compare_specs(tp, jspecs, params, "model",
                          skip=("bn2",)) == 4 * 2 + 2
    assert tp["layer1_0.bn2.running_var"] == Shard(0)
    assert tp["layer1_0.conv2.weight"] == Shard(0)
    assert tp["layer1_0.conv3.weight"] == Shard(1)


def test_tp_keeps_indivisible_heads_replicated():
    """7 heads on a 2-way axis: JAX splits qkv mid-head (GSPMD reshards);
    the port runs local heads, so it keeps qkv and proj whole and splits
    the MLP only."""
    from laudnet_tpu_torch.models import LAUDViT

    model = LAUDViT(depth=1, dim=448, num_heads=7, mlp_ratio=3.0,
                    device="meta")

    class Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return 2

    specs = tensor_parallel_specs(model, VIT_TP_RULES, mesh=Mesh())
    assert isinstance(specs["blocks.0.qkv.weight"], Replicate)
    assert isinstance(specs["blocks.0.proj.weight"], Replicate)
    assert specs["blocks.0.fc1.weight"] == Shard(0)
    assert specs["blocks.0.fc2.weight"] == Shard(1)


def test_tp_splits_grouped_conv2_by_whole_groups_only():
    """A grouped conv2 splits where its groups divide over the axis (4
    groups on 2 ranks) and stays replicated, with bn2 and conv3, where
    they do not (3 groups): never mid-group."""
    from laudnet_tpu_torch.models import LAUDResNet

    class Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return 2

    for groups, split in ((4, True), (3, False)):
        model = LAUDResNet(layers=(1, 1, 1, 1), width_mult=0.5,
                           group_width=groups, device="meta")
        specs = tensor_parallel_specs(model, RESNET_TP_RULES, mesh=Mesh())
        for name, dim in (("conv2.weight", 0), ("bn2.running_var", 0),
                          ("conv3.weight", 1)):
            want = Shard(dim) if split else Replicate()
            assert specs[f"layer2_0.{name}"] == want, (groups, name)
        assert specs["fc.weight"] == Shard(0)


def test_loader_shards_partition_the_epoch_as_jax():
    """The multi-process shard contract: each rank's indices are JAX's,
    and the shards partition the wrap-padded, epoch-seeded order."""
    from laudnet_tpu.data.loader import DataLoader as JLoader
    from laudnet_tpu_torch.data.loader import epoch_order

    class FakeDS:
        samples = [(str(i), i) for i in range(30)]

        def __len__(self):
            return 30

        def load(self, i, seed):
            return np.full((2, 2, 3), i, np.float32), i

    got = [epoch_order(30, 7, 3, True, (r, 4)) for r in range(4)]
    assert {len(g) for g in got} == {8}
    assert set(np.concatenate(got).tolist()) == set(range(30))
    for r in range(4):
        labels = np.concatenate([lab for _, lab in JLoader(
            FakeDS(), batch_size=4, num_workers=1, seed=7,
            shard=(r, 4)).epoch(3)])
        np.testing.assert_array_equal(labels, got[r])


def test_model_outputs_are_pytree_nodes():
    """FSDP2 finds a forward's output tensors by walking the output, and
    the torch the card machine runs walks it as a pytree: a dataclass that
    is no pytree node hides every tensor, FSDP hooks no gradient gather,
    and the backward reads freed parameter storage (seen on the H100
    machine's torch 2.11 under `--fsdp`)."""
    from torch.utils._pytree import tree_flatten

    from laudnet_tpu_torch.models.laud_resnet import LAUDOutput
    from laudnet_tpu_torch.models.laud_vit import LAUDViTOutput

    t = torch.zeros(1, requires_grad=True)
    vit, _ = tree_flatten(LAUDViTOutput(*[t] * 8))
    cnn, _ = tree_flatten(LAUDOutput(t, (t, t), (t,), (t,), (t,), t, t))
    assert len(vit) == 8 and len(cnn) == 8
