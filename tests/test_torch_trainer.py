"""The training slice as a whole: two consecutive steps of the port's
`train.trainer.make_train_step` against two of
`laudnet_tpu.train.trainer.make_train_step`, with the same student and
teacher weights (`load_flax_variables`), the same batch and the same Gumbel
noise (the JAX step runs eagerly while ``jax.random.gumbel`` is wrapped to
record what it returns; the port replays the record).

Every metric agrees to 1e-4 relative (f32), and the parameters after the
last step agree leaf by leaf through the inverse mapping `to_flax_tree` (rtol 1e-4,
atol 1e-6: step 2 shows the momentum, the weight decay and the second
learning rate). Once with ``attn_impl='fused'``: the JAX kernels, forward
and backward, in interpret mode against the port's Function.

Token gates make the comparison sensitive to the last bit of the soft
Gumbel sample: the straight-through forward ``y_hard + y_soft -
stop_gradient(y_soft)`` is 1 - 2^-24 for some kept tokens, and the key mask
turns that into a score offset of -59.6 (both packages alike, see
`tests/test_torch_laud_vit_train.py`). Whether a kept token gets the
residue hangs on the last bit of its soft sample, where the two frameworks'
pair softmax sometimes differ, and one such token changes the step by O(1):
its gradients too, even where a closed layer gate hides it from the loss
(the gate's own gradient is the hidden branch's output). Measured with the
``token_gates`` case at seeds 0 to 15, one step: the metrics agree at 8
seeds, the metrics and every updated leaf at one (seed 14, the one kept
here); two steps: at none of seeds 0 to 23.

That the residue is the whole of it is shown by ``token_gates_two_steps``:
every gate, two steps, every metric and every updated leaf, with the
straight-through sum of BOTH packages re-associated, in this process only,
to ``y_hard + (y_soft - stop_gradient(y_soft))``. That is the same
estimator (same forward decision, same gradient), exactly 0 or 1 in the
forward, so no last bit reaches the key mask: seeds 0 to 11 all agree. The
formula the packages ship is held to JAX bit for bit in
`tests/test_torch_gating.py`."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laudnet_tpu.models import laud_vit as jlv
from laudnet_tpu.ops import gating as jgating
from laudnet_tpu.train import optim as jo
from laudnet_tpu.train import trainer as jt
from laudnet_tpu_torch.convert.from_jax import (load_flax_variables,
                                                to_flax_tree)
from laudnet_tpu_torch.models import laud_vit as tlv
from laudnet_tpu_torch.ops import gating as tgating
from laudnet_tpu_torch.ops.gating import ReplayNoise
from laudnet_tpu_torch.train import optim as to
from laudnet_tpu_torch.train import trainer as tt

torch.set_num_threads(1)
GEOM = dict(depth=2, dim=128, num_heads=2, mlp_ratio=2.0, num_classes=11)
DENSE = dict(token_skip=False, head_skip=False, layer_skip=False)
CFG = dict(num_epochs=2, steps_per_epoch=3, base_lr=0.05, t0=5.0, t_last=0.5,
           t_last_epoch=2, lambda_act=10.0, alpha_kd=0.5, t_kd=4.0,
           target_rate=0.5)
METRICS = ("loss", "loss_cls", "loss_kd", "loss_flops", "act_rate", "flops",
           "lr", "temperature", "top1", "top5")


def _init(model, x, seed):
    v = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(seed)},
                                   jnp.asarray(x), 1.0, training=False))()
    return jax.tree_util.tree_map(np.array, v["params"])


def _randomise_policies(params, seed):
    """Zero policy biases and random kernels: the gates close decisions."""
    rng = np.random.default_rng(seed)
    for name, blk in params.items():
        if name.startswith("block_"):
            for head in ("token_policy", "head_policy", "layer_policy"):
                if head not in blk:
                    continue
                blk[head]["bias"] = np.zeros_like(blk[head]["bias"])
                blk[head]["kernel"] = (rng.standard_normal(
                    blk[head]["kernel"].shape) * 0.2).astype(np.float32)
    return params


HEAD_AND_LAYER = dict(token_skip=False)
CASES = {
    # head and layer gates, which no last bit can upset: two steps
    "reference": dict(attn_impl="reference", gates=HEAD_AND_LAYER, steps=2,
                      batch=4, seed=5),
    # the same through the JAX kernels, forward and backward, in interpret
    # mode against the port's Function
    "fused": dict(attn_impl="fused", gates=HEAD_AND_LAYER, steps=2, batch=4,
                  seed=5),
    # every gate with the formula as shipped: one step, at the seed where
    # the two frameworks' soft samples agree to the bit on every kept token
    # (the docstring says how the seed was found)
    "token_gates": dict(attn_impl="reference", gates={}, steps=1, batch=2,
                        seed=14),
    # every gate, two steps, the straight-through sum re-associated on both
    # sides so that no residue exists: robust to the last bit at any seed
    "token_gates_two_steps": dict(attn_impl="reference", gates={}, steps=2,
                                  batch=2, seed=3, residue_free=True),
}


def _jax_gumbel_softmax_residue_free(key, logits, tau, axis=-1, hard=True):
    """`laudnet_tpu.ops.gating.gumbel_softmax` (hard) with its last line
    re-associated: forward exactly ``y_hard``, gradient the soft sample's."""
    gumbels = jax.random.gumbel(key, logits.shape, dtype=logits.dtype)
    y_soft = jax.nn.softmax((logits + gumbels) / tau, axis=axis)
    y_hard = jax.nn.one_hot(
        jnp.argmax(y_soft, axis=axis), logits.shape[axis],
        axis=axis if axis >= 0 else logits.ndim + axis, dtype=logits.dtype)
    return y_hard + (y_soft - jax.lax.stop_gradient(y_soft))


def _torch_gumbel_softmax_residue_free(noise, logits, tau, dim=-1, hard=True):
    """The port's `gumbel_softmax` (hard), re-associated in the same way."""
    gumbels = noise.gumbel(logits.shape, logits.dtype, logits.device)
    y_soft = torch.softmax((logits + gumbels) / tau, dim=dim)
    y_hard = torch.nn.functional.one_hot(
        y_soft.argmax(dim=dim), logits.shape[dim]).to(logits.dtype)
    y_hard = y_hard.movedim(-1, dim if dim >= 0 else logits.dim() + dim)
    return y_hard + (y_soft - y_soft.detach())


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_train_steps_match_jax(monkeypatch, case):
    attn_impl, seed, gates, steps, batch = (
        CASES[case][k] for k in ("attn_impl", "seed", "gates", "steps",
                                 "batch"))
    n_gates = 3 - len(gates)
    if CASES[case].get("residue_free"):
        monkeypatch.setattr(jgating, "gumbel_softmax",
                            _jax_gumbel_softmax_residue_free)
        monkeypatch.setattr(tgating, "gumbel_softmax",
                            _torch_gumbel_softmax_residue_free)
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 11, (batch,)).astype(np.int32)
    jmodel = jlv.LAUDViT(**GEOM, **gates, attn_impl=attn_impl)
    jteacher = jlv.LAUDViT(**GEOM, **DENSE, attn_impl=attn_impl)
    params = _randomise_policies(_init(jmodel, images, 0), 1)
    tparams = _init(jteacher, images, 2)
    full_flops = jlv.vit_dense_flops(jmodel, input_size=32)
    assert full_flops == tlv.vit_dense_flops(
        tlv.LAUDViT(**GEOM, **gates, img_size=32, device="meta"),
        input_size=32)

    # --- JAX: two eager steps, Gumbel noise recorded in call order -------
    recorded = []
    original = jax.random.gumbel

    def recording(key, shape=(), dtype=float, **kw):
        out = original(key, shape, dtype, **kw)
        recorded.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "gumbel", recording)
    jcfg = jt.TrainConfig(full_flops=full_flops, **CFG)
    jopt = jo.make_sgd(params, weight_decay=1e-3)
    state = jt.create_train_state(jmodel, jopt, None, rng=None,
                                  variables={"params": params})
    jstep = jt.make_train_step(jmodel, jteacher, {"params": tparams}, jopt,
                               jcfg)
    jmetrics = []
    for _ in range(steps):
        state, m = jstep(state, jnp.asarray(images), jnp.asarray(labels),
                         jax.random.PRNGKey(7))
        jmetrics.append({k: float(v) for k, v in m.items()})
    monkeypatch.setattr(jax.random, "gumbel", original)
    assert len(recorded) == steps * n_gates * GEOM["depth"]

    # --- the port: the same two steps on the replayed noise --------------
    model = tlv.LAUDViT(**GEOM, **gates, attn_impl=attn_impl, img_size=32,
                        device="cpu")
    teacher = tlv.LAUDViT(**GEOM, **DENSE, attn_impl=attn_impl, img_size=32,
                          device="cpu")
    load_flax_variables(model, params)
    load_flax_variables(teacher, tparams)
    teacher.requires_grad_(False)
    opt = to.make_sgd(model, weight_decay=1e-3)
    noise = ReplayNoise(recorded)
    step = tt.make_train_step(model, teacher, opt,
                              tt.TrainConfig(full_flops=full_flops, **CFG),
                              noise=noise)
    tstate = tt.TrainState(step=0, model=model, optimizer=opt)
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    for i in range(steps):
        m = step(tstate, x, y)
        assert sorted(m) == sorted(METRICS)
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), jmetrics[i][k],
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
    assert tstate.step == steps == int(state.step)
    assert noise.used == len(recorded)
    assert steps == 1 or jmetrics[0]["lr"] != jmetrics[1]["lr"]
    assert jmetrics[0]["act_rate"] < 1.0      # the gates closed something

    got = dict(jax.tree_util.tree_leaves_with_path(to_flax_tree(model)))
    ref = jax.tree_util.tree_leaves_with_path(state.params)
    assert len(ref) == len(got)
    moved = 0
    for path, leaf in ref:
        np.testing.assert_allclose(got[path], np.asarray(leaf), rtol=1e-4,
                                   atol=1e-6, err_msg=str(path))
        before = params
        for key in path:
            before = before[key.key]
        moved += not np.array_equal(got[path], before)
    assert moved >= len(ref) - 6     # all but a closed branch's leaves moved
    assert all(p.grad is None for p in teacher.parameters())


def test_step_seed_depends_on_seed_and_step_only():
    """A resumed run draws what an uninterrupted one would: the step's
    Gumbel seed is a function of (seed, step), and two trainers at the same
    step produce the same gates whatever they ran before."""
    assert tt.step_seed(3, 5) == tt.step_seed(3, 5)
    assert len({tt.step_seed(s, t) for s in range(3) for t in range(4)}) == 12
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 3)).astype(np.float32))
    y = torch.tensor([1, 2])
    cfg = tt.TrainConfig(num_epochs=1, steps_per_epoch=4,
                         full_flops=float(tlv.vit_dense_flops(
                             tlv.LAUDViT(**GEOM, img_size=32, device="meta"),
                             input_size=32)))

    def trainer():
        gen = torch.Generator().manual_seed(0)
        model = tlv.LAUDViT(**GEOM, img_size=32, device="cpu", generator=gen)
        teacher = tlv.LAUDViT(**GEOM, **DENSE, img_size=32, device="cpu",
                              generator=gen)
        opt = to.make_sgd(model)
        return (tt.TrainState(0, model, opt),
                tt.make_train_step(model, teacher, opt, cfg, seed=11))

    a_state, a_step = trainer()
    first = a_step(a_state, x, y)
    saved = copy.deepcopy((a_state.model.state_dict(),
                           a_state.optimizer.state_dict()))
    second = a_step(a_state, x, y)
    b_state, b_step = trainer()                     # resumed at step 1
    b_state.model.load_state_dict(saved[0])
    b_state.optimizer.load_state_dict(saved[1])
    b_state.step = 1
    resumed = b_step(b_state, x, y)
    for k in METRICS:
        assert float(resumed[k]) == float(second[k]), k
    assert float(second["loss"]) != float(first["loss"])


def test_eval_step_and_teacher_logits():
    gen = torch.Generator().manual_seed(1)
    model = tlv.LAUDViT(**GEOM, img_size=32, device="cpu", generator=gen)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 32, 32, 3)).astype(np.float32))
    y = torch.tensor([0, 1, 2, 3])
    cfg = tt.TrainConfig(full_flops=1.0)
    stats = tt.make_eval_step(model, cfg)(x, y)
    assert float(stats["n_valid"]) == 4.0
    for k in ("token_density", "head_density", "attn_density",
              "mlp_density"):
        assert stats[k].shape == (GEOM["depth"],)
    w = torch.tensor([1.0, 1.0, 0.0, 0.0])
    weighted = tt.make_eval_step(model, cfg)(x, y, w)
    assert float(weighted["n_valid"]) == 2.0
    logits = tt.teacher_logits_fn(model, x)
    assert logits.shape == (4, 11) and not logits.requires_grad
    assert tt.teacher_logits_fn(lambda im, training: im.sum((1, 2)), x
                                ).shape == (4, 3)
    with pytest.raises(ValueError, match="unknown sparsity"):
        tt.compute_sparsity_loss(
            tt.TrainConfig(sparsity_criterion="nope"), 0.0, None)
    # the CNN criteria read densities a ViT output does not have
    out = model(x)
    for name in tt.CNN_CRITERIA:
        with pytest.raises(AttributeError, match="channel_s"):
            tt.compute_sparsity_loss(
                tt.TrainConfig(sparsity_criterion=name), 0.0, out)


# --- the CNN family ---------------------------------------------------------

CNN_KW = dict(layers=(1, 1, 1, 1), num_classes=10, input_size=64,
              width_mult=0.25,
              dyn_mode=("spatial", "channel", "both", "layer"),
              mask_spatial_granularity=(4, 2, 1, 1),
              channel_dyn_granularity=(1, 2, 2, 1),
              channel_masker=("MLP", "MLP", "conv_linear", "MLP"),
              channel_masker_layers=(1, 2, 2, 1),
              reduction_ratio=(16, 16, 8, 16))


@pytest.mark.parametrize("criterion", ("bounds",) + tt.CNN_CRITERIA)
def test_cnn_sparsity_criteria_dispatch_as_jax(criterion):
    """Every criterion on the same densities through both dispatchers: a
    handful of f32 means and squares, rtol 1e-6."""
    from laudnet_tpu.models.laud_resnet import LAUDOutput as JOut
    from laudnet_tpu_torch.models.laud_resnet import LAUDOutput as TOut

    rng = np.random.default_rng(3)
    stages = lambda: tuple(rng.random(n).astype(np.float32)
                           for n in (3, 4, 6, 3))
    fields = dict(spatial_s3=stages(), spatial_s2=stages(),
                  spatial_s1=stages(), channel_s=stages(),
                  flops_perc=rng.random(16).astype(np.float32),
                  flops=np.float32(2.3e9))
    j = JOut(logits=None, **jax.tree_util.tree_map(jnp.asarray, fields))
    t = TOut(logits=None, **jax.tree_util.tree_map(torch.from_numpy, dict(
        fields, flops=np.asarray(fields["flops"]))))
    kw = dict(num_epochs=10, target_rate=0.4, full_flops=4.1e9,
              sparsity_criterion=criterion,
              dyn_mode=("both", "spatial", "both", "channel"))
    for epoch in (0.0, 3.5, 9.0):
        ref = jt.compute_sparsity_loss(jt.TrainConfig(**kw), epoch, j)
        got = tt.compute_sparsity_loss(tt.TrainConfig(**kw), epoch, t)
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("steps,conv_impl", [(2, "dense")])
def test_cnn_train_steps_match_jax(monkeypatch, steps, conv_impl):
    """LAUD-ResNet student, dense ResNet teacher: the metrics of every step
    (rtol 1e-4), then the parameters AND the BatchNorm running statistics
    leaf by leaf after EACH step (flax keeps the biased batch variance at
    momentum 0.9, and so must the port). After the first step rtol 1e-4
    with atol 1e-5: both sides start from the same bits and differ in f32
    summation order only (measured: 2e-6 at most, in a running variance).
    The second step starts from those differences, and BatchNorm's
    backward multiplies them by 1 / sqrt(var + 1e-5), which is up to 316
    for the channels a ReLU has all but switched off: its updates agree to
    about 1e-3 of their size (measured 4e-5 at most, on the stem kernel),
    so atol 2e-4 there, still a hundredth of an update. The
    straight-through residue multiplies features here and never becomes a
    score offset, so this holds with every gate at the shipped formula.
    ``int8_qat`` is not run through this test: XLA compiles the
    fake-quantiser's divide otherwise than eager JAX computes it and a few
    codes flip; the QAT convolution is held to eager flax, values and
    gradients, in `tests/test_torch_quant.py`, and the QAT train step runs
    through the CLI in `tests/test_torch_train_cli.py`.

    The JAX step is jitted (eager it takes minutes), so the Gumbel noise
    cannot be recorded from ``jax.random.gumbel``: that is replaced by
    numpy draws, which the trace bakes in, and the port replays the same
    draws in every step, as the compiled JAX step does."""
    from laudnet_tpu.models import laud_resnet as jlr
    from laudnet_tpu.models import resnet as jr
    from laudnet_tpu_torch.convert.from_jax import to_flax_batch_stats
    from laudnet_tpu_torch.models import laud_resnet as tlr
    from laudnet_tpu_torch.models import resnet as tr
    from laudnet_tpu_torch.utils.flops import resnet_full_flops

    rng = np.random.default_rng(4)
    images = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (4,)).astype(np.int32)
    jmodel = jlr.LAUDResNet(**CNN_KW, conv_impl=conv_impl)
    jteacher = jr.ResNet(layers=(1, 1, 1, 1), num_classes=10,
                         width_mult=0.25)

    # the port's own initialiser draws the weights (no XLA compilation of
    # ``init``); they reach JAX through the inverse mapping
    gen = torch.Generator().manual_seed(0)
    donor = tlr.LAUDResNet(**CNN_KW, conv_impl=conv_impl, device="cpu",
                           generator=gen)
    tdonor = tr.ResNet(layers=(1, 1, 1, 1), num_classes=10, width_mult=0.25,
                       device="cpu", generator=gen)
    v, tv = ({"params": to_flax_tree(m),
              "batch_stats": to_flax_batch_stats(m)} for m in (donor, tdonor))
    for blk in v["params"].values():            # let the gates close
        for head in ("masker_spatial", "masker_channel"):
            for leaf in blk.get(head, {}).values():
                if isinstance(leaf, dict) and "bias" in leaf:
                    leaf["bias"] = np.zeros_like(leaf["bias"])
    full_flops = resnet_full_flops((1, 1, 1, 1), 64, 0.25, 10)

    recorded = []
    noise_rng = np.random.default_rng(11)

    def numpy_gumbel(key, shape=(), dtype=float, **kw):
        recorded.append(noise_rng.gumbel(size=shape).astype(np.float32))
        return jnp.asarray(recorded[-1])

    monkeypatch.setattr(jax.random, "gumbel", numpy_gumbel)
    cfg = dict(CFG, sparsity_criterion="cs", dyn_mode=CNN_KW["dyn_mode"])
    jopt = jo.make_sgd(v["params"], weight_decay=1e-3)
    state = jt.create_train_state(jmodel, jopt, None, rng=None, variables=v)
    jstep = jax.jit(jt.make_train_step(
        jmodel, jteacher, tv, jopt,
        jt.TrainConfig(full_flops=full_flops, **cfg)))
    jmetrics, jstates = [], []
    for _ in range(steps):
        state, m = jstep(state, jnp.asarray(images), jnp.asarray(labels),
                         jax.random.PRNGKey(7))
        jmetrics.append({k: float(v_) for k, v_ in m.items()})
        jstates.append(state)
    monkeypatch.undo()
    assert len(recorded) == 5           # 1 + 1 + 2 + 1 maskers, traced once
    recorded = recorded * steps

    model = tlr.LAUDResNet(**CNN_KW, conv_impl=conv_impl, device="cpu")
    teacher = tr.ResNet(layers=(1, 1, 1, 1), num_classes=10, width_mult=0.25,
                        device="cpu")
    load_flax_variables(model, v)
    load_flax_variables(teacher, tv)
    teacher.requires_grad_(False)
    opt = to.make_sgd(model, weight_decay=1e-3)
    noise = ReplayNoise(recorded)
    step = tt.make_train_step(model, teacher, opt,
                              tt.TrainConfig(full_flops=full_flops, **cfg),
                              noise=noise)
    tstate = tt.TrainState(step=0, model=model, optimizer=opt)
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    for i in range(steps):
        m = step(tstate, x, y)
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), jmetrics[i][k],
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"step {i} {k}")
        for ours, theirs in (
                (to_flax_tree(model), jstates[i].params),
                (to_flax_batch_stats(model), jstates[i].batch_stats)):
            got = dict(jax.tree_util.tree_leaves_with_path(ours))
            ref = jax.tree_util.tree_leaves_with_path(theirs)
            assert len(ref) == len(got) > 0
            for path, leaf in ref:
                np.testing.assert_allclose(
                    got[path], np.asarray(leaf), rtol=1e-4,
                    atol=1e-5 if i == 0 else 2e-4,
                    err_msg=f"step {i} {path}")
    assert noise.used == len(recorded)
    assert jmetrics[0]["act_rate"] < 1.0
    # the statistics moved, and the teacher's did not
    assert float(model.bn1.running_mean.abs().max()) > 0
    assert float(teacher.bn1.running_mean.abs().max()) == 0


def test_cnn_eval_step_reports_the_stage_densities():
    from laudnet_tpu_torch.models import laud_resnet as tlr

    model = tlr.LAUDResNet(**CNN_KW, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    stats = tt.make_eval_step(model, tt.TrainConfig(full_flops=1.0))(
        x, torch.tensor([0, 1]))
    for k in ("spatial_s3", "spatial_s2", "spatial_s1", "channel_s"):
        assert [tuple(v.shape) for v in stats[k]] == [(1,)] * 4
    assert "token_density" not in stats
    assert float(stats["flops"]) > 0
