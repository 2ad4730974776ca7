"""The training CLI's distributed flags and the multi-device dry run, on
gloo ranks on the CPU (modelled on `tests/test_multihost.py`): two real
processes join through ``--dist_coordinator`` and train with plain data
parallelism, ``--tp 2``, ``--pp 2`` and ``--fsdp``; rank 0 alone writes;
the checkpoints hold the single-device layout (a one-process model loads
them) and an FSDP run resumes from its own. The JAX CLI's refusals of
layouts that do not fit, with its messages, need no second process.
`entry.dryrun_multichip(2)` prints every leg's ``ok``."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from laudnet_tpu_torch.parallel.mesh import free_port
from laudnet_tpu_torch.train import main as tmain

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--arch", "laud_deit_tiny", "--device", "cpu", "--input_size", "32",
        "--num_classes", "10", "--batch_size", "8", "--steps_per_epoch", "2",
        "--t_last_epoch", "1", "--print_freq", "1", "--lambda_act", "0.1",
        "--t0", "1.0", "--t_last", "0.5"]


def run_ranks(argv, n=2, timeout=300):
    """``train.main`` in ``n`` processes joined over gloo; their outputs."""
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "laudnet_tpu_torch.train.main", *argv,
         "--dist_coordinator", f"127.0.0.1:{port}",
         "--dist_num_processes", str(n), "--dist_process_id", str(r)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
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
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def _first_loss(log: str, epoch: int = 0) -> float:
    first = [ln for ln in log.splitlines()
             if ln.startswith(f"epoch {epoch} [0/")]
    assert first, log[-2000:]
    return float(first[0].split("loss")[1].split()[0])


def test_two_process_distributed_train(tmp_path):
    """Plain data parallelism: each process loads 4 of the 8 images;
    process 0 logs and owns the files, process 1 is quiet."""
    out = tmp_path / "out"
    outs = run_ranks(BASE + ["--epochs", "1", "--train_url", str(out)])
    assert "2 processes" in outs[0]
    assert "epoch" not in outs[1]
    log = (out / "train.log").read_text()
    assert np.isfinite(_first_loss(log))
    rows = (out / "log.txt").read_text().strip().splitlines()
    assert len(rows) == 2 and np.isfinite(float(rows[1].split(",")[3]))


def _one_process_model(argv):
    return tmain.build_training(tmain.parse_args(argv),
                                log=lambda *a: None).model


@pytest.mark.parametrize("layout", ["tp", "tp_indivisible", "tp_qat",
                                    "tp_qat_cnn", "pp", "fsdp"])
def test_parallel_layouts_train_through_the_cli(tmp_path, layout):
    """``--tp 2`` (LAUD-DeiT-S: the fused attention on 3 heads a rank;
    LAUD-DeiT-Ti's 3 heads do not divide: qkv and proj stay replicated and
    the fused attention runs all heads, as logged), ``--tp 2 --vit_linear
    int8_qat`` (LAUD-DeiT-Ti: fc1 and fc2 split) and ``--arch uni_resnet50
    --tp 2 --conv_impl int8_qat`` (fake-quant products in the steps, W8A8
    in the validation, fc2 and conv3 with their scales over the whole
    input),
    ``--pp 2`` (6 blocks a stage) and ``--fsdp`` (then
    resumed): a finite first loss, the layout logged, and a checkpoint
    that a one-process model of the same flags loads."""
    arch = {"tp": ["--arch", "laud_deit_small"],
            "tp_qat_cnn": ["--arch", "uni_resnet50"]}.get(layout, [])
    flags = arch + {"tp": ["--tp", "2", "--vit_attn", "fused"],
             "tp_indivisible": ["--tp", "2", "--vit_attn", "fused"],
             "tp_qat": ["--tp", "2", "--vit_linear", "int8_qat"],
             "tp_qat_cnn": ["--tp", "2", "--conv_impl", "int8_qat"],
             "pp": ["--pp", "2", "--pp_microbatches", "2"],
             "fsdp": ["--fsdp"]}[layout]
    out = tmp_path / "out"
    argv = BASE + flags + ["--train_url", str(out)]
    run_ranks(argv + ["--epochs", "1"])
    log = (out / "train.log").read_text()
    assert np.isfinite(_first_loss(log))
    tp_log = "TP: Megatron {} layout over model axis (tp=2, dp=1)"
    assert {"tp": tp_log.format("vit"),
            "tp_indivisible": "--tp 2 does not divide 3 heads",
            "tp_qat": tp_log.format("vit"),
            "tp_qat_cnn": tp_log.format("resnet"),
            "pp": "PP: GPipe 2 stages x 6 layers/stage, 2 microbatches",
            "fsdp": "FSDP: params + optimizer state sharded"}[layout] in log
    if layout.startswith("tp_qat"):   # the W8A8 validation's metrics
        rows = (out / "log.txt").read_text().strip().splitlines()
        assert all(np.isfinite(float(v)) for v in rows[1].split(","))
    payload = torch.load(out / "ckpt" / "step_2.pt", weights_only=True)
    model = _one_process_model(BASE + arch)
    model.load_state_dict(payload["model"])        # the full shapes
    assert len(payload["optimizer"]["state"]) == sum(
        1 for p in model.parameters() if p.requires_grad)
    if layout == "fsdp":
        run_ranks(argv + ["--epochs", "2"])
        log = (out / "train.log").read_text()
        assert "auto-resumed from step 2" in log
        assert np.isfinite(_first_loss(log, epoch=1))


def _lay_out(flags, n_proc, local_bs, depth=6):
    args = tmain.parse_args(BASE + flags)
    model = types.SimpleNamespace(depth=depth, num_heads=3)
    return tmain.lay_out(args, model, n_proc, local_bs, local_bs * n_proc,
                         torch.device("cpu"), lambda *a: None)


@pytest.mark.parametrize("flags,n_proc,local_bs,message", [
    (["--arch", "lad_regnet_y_400mf", "--tp", "2"], 2, 4,
     "--tp supports ViT and ResNet archs"),
    (["--tp", "2"], 1, 8, r"--tp 2 must divide the device count \(1\)"),
    (["--arch", "uni_resnet50", "--pp", "2"], 2, 4,
     "--pp supports ViT archs only"),
    (["--pp", "2", "--fsdp"], 2, 4, "--pp is exclusive with --tp/--fsdp"),
    (["--pp", "2"], 1, 8, r"--pp 2 must divide the device count \(1\)"),
    (["--pp", "4"], 4, 2, r"--pp 4 must divide the model depth \(6\)"),
    (["--pp", "2", "--pp_microbatches", "4"], 2, 3,
     "global batch 6 must be divisible by --pp_microbatches 4"),
    (["--pp", "2", "--pp_microbatches", "4"], 4, 1,
     r"microbatch 1 \(--batch_size 4\) must be divisible by the data axis "
     r"\(4 devices / tp\*pp 2 = 2\)"),
], ids=["tp_regnet", "tp_devices", "pp_cnn", "pp_fsdp", "pp_devices",
        "pp_depth", "pp_microbatches", "pp_data_axis"])
def test_cli_refuses_layouts_that_do_not_fit(flags, n_proc, local_bs,
                                             message):
    """The JAX CLI's checks (`laudnet_tpu/train/main.py:409-450`), its
    messages, before any group or mesh is made."""
    with pytest.raises(SystemExit, match=message):
        _lay_out(flags, n_proc, local_bs)


def test_a_coordinator_needs_a_process_count(tmp_path):
    with pytest.raises(ValueError, match="num_processes is unset"):
        tmain.main(BASE + ["--train_url", str(tmp_path),
                           "--dist_coordinator", "127.0.0.1:1"])
    assert not (tmp_path / "train.log").exists()


def test_dryrun_multichip_prints_every_leg():
    """`entry.dryrun_multichip(2)` with no card: two gloo ranks on the CPU
    run JAX's legs, each also held to one process on the whole batch."""
    code = ("from laudnet_tpu_torch.entry import dryrun_multichip; "
            "dryrun_multichip(2)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO,
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.splitlines()
    for leg in ("): ok —", "tp ok", "sp ok", "fsdp ok", "pp ok"):
        assert sum(leg in ln for ln in lines) == 1, (leg, out.stdout)
    distances = json.loads(next(ln for ln in lines if ln.startswith(
        "dryrun_multichip distances: ")).split(": ", 1)[1])
    assert max(distances.values()) < 1e-4, distances


def test_dryrun_multichip_data_parallel_legs():
    """``model_parallel=1``: the dp and fsdp legs on a dp2 x tp1 mesh, so
    the data group's exchanges (global gate densities, gradient and metric
    means, FSDP's gathers and reduce-scatters) run across two ranks."""
    code = ("from laudnet_tpu_torch.entry import dryrun_multichip; "
            "dryrun_multichip(2, model_parallel=1, legs=('dp', 'fsdp'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO,
                                  OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert any("(dp2 x tp1;" in ln for ln in lines), out.stdout
    assert any("fsdp ok" in ln and "dp2 x tp1" in ln for ln in lines)
    distances = json.loads(next(ln for ln in lines if ln.startswith(
        "dryrun_multichip distances: ")).split(": ", 1)[1])
    assert sorted(distances) == ["dp", "fsdp"]
    assert max(distances.values()) < 1e-4, distances
