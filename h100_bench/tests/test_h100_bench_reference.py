"""Each plain reference against the port's model at a tiny size on the CPU,
in float32: the same weights and images give the same logits, gates and
densities. The reference modules themselves import nothing of the port;
only this test does."""

from __future__ import annotations

import pytest
import torch

from bench_tiny import DEIT, RESNET, tiny_run
from h100_bench import images
from h100_bench import run as R


def _pool(run, n=2):
    g = torch.Generator().manual_seed(run.sub_seed(1))
    return images.make(run.traffic.get("image", {}),
                       run.config["image_size"], n, g, "cpu")


@pytest.mark.parametrize("seed", [3, 2 ** 40 + 1])
def test_deit_reference_matches_the_port(seed):
    run = tiny_run(DEIT, seed=seed, dtype="float32")
    weights = run.program.make_weights(run)
    x = _pool(run, 4)
    served = run.program.build_serve(run, weights)(x)
    ref, info = run.reference.forward(weights, x, run.config)
    torch.testing.assert_close(served, ref, rtol=1e-4, atol=1e-4)
    # the gathers ran: blocks 1 and 3 cut the 17 tokens to 11 and to 8
    assert info["tokens"][0].tolist() == [17, 11, 11, 8]


def test_deit_gate_margin_reads_a_token_left_out():
    """Following its own gathers the reference reads no disagreement; a
    kept token that a served call left out reads its distance from the
    gate's boundary, far from the tie."""
    run = tiny_run(DEIT, dtype="float32")
    weights = run.program.make_weights(run)
    x = _pool(run, 4)
    logits, info = run.reference.forward(weights, x, run.config)
    again, own = run.reference.forward(weights, x, run.config,
                                       state=info["state"])
    torch.testing.assert_close(again, logits, rtol=0, atol=0)
    assert own["disagree"].sum() == 0 and own["flip_margin"].max() == 0
    assert (own["cells"] > 0).all()
    state = [(a.clone(), m.clone()) for a, m in info["state"]]
    kept = state[0][1][0].nonzero().flatten()
    state[0][1][0, kept[1]] = 0.0  # the first image's second kept token
    _, left = run.reference.forward(weights, x, run.config, state=state)
    assert left["disagree"][0] >= 1 and left["disagree"][1:].sum() == 0
    assert left["flip_margin"][0] > 0.05


def test_deit_snapped_counts_are_the_engines():
    from laudnet_tpu_torch.infer.fused_vit import snap_capacity_to_tiles

    run = tiny_run(DEIT)
    cfg = dict(
        run.config, num_hidden_layers=12, image_size=224,
        token_capacity=[1.0] * 3 + [0.7] * 4 + [0.5] * 5,
        snap_capacities=True)
    assert run.reference.token_counts(cfg) == [197] * 3 + [128] * 4 + [96] * 5
    for k in range(2, 400):
        assert run.reference.snap(k) == snap_capacity_to_tiles(k)


@pytest.mark.parametrize("seed", [3, 2 ** 40 + 1])
def test_resnet_reference_matches_the_port(seed):
    run = tiny_run(RESNET, seed=seed, dtype="float32")
    weights = run.program.make_weights(run)
    x = _pool(run, 4)
    model = run.program.model(run, weights)
    with torch.no_grad():
        out = model(x, run.config["temperature"], training=False)
    ref, info = run.reference.forward(weights, x, run.config)
    torch.testing.assert_close(out.logits, ref, rtol=1e-4, atol=1e-4)
    s3 = torch.cat([s.t() for s in out.spatial_s3_img], dim=1)
    torch.testing.assert_close(s3, info["s3"])
    # about half of the cells closed; the masks differ from image to image
    assert 0.1 < float(info["s3"].mean()) < 0.9
    assert float(info["s3"].std()) > 0
    # the densities of the model's own bookkeeping, per image
    flops = torch.stack([s.sum() for s in out.spatial_s3_img])
    assert torch.isfinite(flops).all()


def test_weight_names_are_the_ports():
    from laudnet_tpu_torch.models.laud_resnet import uni_resnet50
    from laudnet_tpu_torch.models.laud_vit import laud_deit_small

    for workload, build in ((DEIT, lambda: laud_deit_small(
            head_skip=False, layer_skip=False, device="meta")),
            (RESNET, lambda: uni_resnet50(
                dyn_mode=("spatial",) * 4,
                mask_spatial_granularity=(4, 4, 2, 1), device="meta"))):
        run = tiny_run(workload)
        cfg = R.load_json(run.root / "configs"
                          / f"{run.cell['config']}.json")
        args = ((cfg,) if workload == DEIT
                else (cfg, run.reference.blocks(cfg)))
        table = run.program.shapes(*args)
        state = build().state_dict()
        assert set(table) == set(state)
        for name, shape in table.items():
            assert tuple(state[name].shape) == tuple(shape), name


def test_resnet_training_gate_margin_reads_a_flipped_cell():
    """Following its own gate decisions the training reference reads no
    disagreement; one decision flipped far from its tie reads its margin,
    in units of the block's root mean square margin."""
    run = tiny_run(RESNET, dtype="float32")
    weights = run.program.make_weights(run)
    teacher = run.program.make_teacher_weights(run)
    x = _pool(run, 4)
    y = torch.tensor([1, 2, 3, 4])
    g = torch.Generator().manual_seed(7)
    noise = [-torch.log(-torch.log(torch.rand(
        4, size // gran, size // gran, 2, 1, generator=g)))
        for *_, size, gran in run.reference.blocks(run.config)]
    recipe = run.config["train"]
    own = run.reference.train_steps(weights, teacher, [(x, y, noise)],
                                    run.config, recipe)
    again = run.reference.train_steps(weights, teacher, [(x, y, noise)],
                                      run.config, recipe, state=own["masks"])
    assert again["mask_disagree"] == 0 and again["gate_flip_margin"] == 0
    masks = [[m.clone() for m in own["masks"][0]]]
    masks[0][0][0, 0, 0, 0] = 1 - masks[0][0][0, 0, 0, 0]
    flipped = run.reference.train_steps(weights, teacher, [(x, y, noise)],
                                        run.config, recipe, state=masks)
    assert flipped["mask_disagree"] > 0 and flipped["gate_flip_margin"] > 0
