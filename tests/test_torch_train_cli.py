"""The port's training CLI (`laudnet_tpu_torch/train/main.py`) on the CPU:
the arguments of the JAX CLI's smoke test (`tests/test_train_cli.py`:
``laud_deit_tiny``, 2 steps, batch 8, 32x32, 10 classes) plus ``--device
cpu``. It writes what the JAX CLI writes, resumes from its own checkpoint,
trains the QAT variant, evaluates a reference-format checkpoint (and
refuses its own ``step_<n>.pt`` there), takes the data slice's flags
(``--data_url``, ``--finetune_from``, ``--teacher_path``, the
augmentations) and refuses the parallel slice's. The CNN archs run the same
way at 32x32
(``uni_resnet50``: 16 blocks, so a 4 x 16 density matrix, rows
s3/s2/s1/channel as the JAX CLI stacks them)."""

import csv
import inspect
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from laudnet_tpu.train import main as jmain
from laudnet_tpu_torch.convert import (save_pth_tar, to_flax_batch_stats,
                                       to_flax_tree)
from laudnet_tpu_torch.train import main as tmain
from laudnet_tpu_torch.train.checkpoint import CheckpointManager
from laudnet_tpu_torch.train.hyperparams import RECIPES, get_hyperparams
from laudnet_tpu_torch.utils.config import Config

torch.set_num_threads(1)
BASE = ["--arch", "laud_deit_tiny", "--device", "cpu",
        "--steps_per_epoch", "2", "--batch_size", "8", "--input_size", "32",
        "--num_classes", "10", "--target_rate", "0.5", "--print_freq", "1"]


def test_train_main_vit_smoke_and_auto_resume(tmp_path):
    best = tmain.main(BASE + ["--epochs", "1", "--train_url", str(tmp_path)])
    assert np.isfinite(best)
    for name in ("train.log", "log.txt", "best_result.txt",
                 "all_density_latest.txt", "all_density_best.txt"):
        assert (tmp_path / name).exists(), name
    dens = np.loadtxt(tmp_path / "all_density_latest.txt")
    assert dens.shape == (4, 12)    # token/head/attn/mlp rows x depth
    assert ((0 <= dens) & (dens <= 1)).all()
    with open(tmp_path / "log.txt") as f:
        rows = list(csv.reader(f))
    # the JAX CLI's header, read from its source
    assert all(f'"{col}"' in inspect.getsource(jmain.main)
               for col in rows[0])
    assert rows[0] == tmain.CSV_HEADER and len(rows) == 2
    assert all(np.isfinite(float(v)) for v in rows[1])
    assert len(open(tmp_path / "best_result.txt").read().split()) == 3
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() == 2
    assert os.path.exists(tmp_path / "ckpt" / "meta_2.json")
    assert os.path.exists(tmp_path / "ckpt" / "best.json")

    # a second call resumes at the saved step and trains epoch 1 only
    tmain.main(BASE + ["--epochs", "2", "--train_url", str(tmp_path)])
    log = open(tmp_path / "train.log").read()
    assert "auto-resumed from step 2" in log
    assert "epoch 1 [0/2]" in log and "epoch 0 [" not in log
    assert ckpt.latest_step() == 4
    with open(tmp_path / "log.txt") as f:
        assert [r[0] for r in csv.reader(f)] == ["epoch", "0", "1"]

    # --evaluate_from the trained weights in a reference (timm) file; the
    # policy heads stay as initialised
    tr = tmain.build_training(tmain.parse_args(BASE), log=lambda *_: None)
    saved = torch.load(tmp_path / "ckpt" / "step_4.pt", weights_only=True)
    tr.model.load_state_dict(saved["model"])
    deit = _write_timm_deit(tr.model, tmp_path / "deit.pth")
    top1 = tmain.main(BASE + ["--train_url", str(tmp_path / "eval"),
                              "--evaluate_from", deit])
    assert 0.0 <= top1 <= 100.0
    assert "evaluate: top1" in open(tmp_path / "eval" / "train.log").read()
    os.unlink(deit)


def _write_timm_deit(model, path, **extra):
    """``model``'s weights under timm's DeiT names (what the reference's
    ViT checkpoints carry; no policy heads), saved as a ``.pth``."""
    tree = to_flax_tree(model)
    state = {"patch_embed.proj.weight":
             tree["patch_embed"]["kernel"].transpose(3, 2, 0, 1),
             "patch_embed.proj.bias": tree["patch_embed"]["bias"],
             "cls_token": tree["cls_token"], "pos_embed": tree["pos_embed"],
             "norm.weight": tree["norm"]["scale"],
             "norm.bias": tree["norm"]["bias"],
             "head.weight": tree["head"]["kernel"].T,
             "head.bias": tree["head"]["bias"]}
    timm = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
            "fc2": "mlp.fc2", "norm1": "norm1", "norm2": "norm2"}
    for i in range(len(model.blocks)):
        for mod, name in timm.items():
            for leaf, v in tree[f"block_{i}"][mod].items():
                state[f"blocks.{i}.{name}." + ("bias" if leaf == "bias"
                                               else "weight")] = (
                    v.T if leaf == "kernel" else v)
    torch.save({"model": {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in state.items()}, **extra}, path)
    return str(path)


def _write_reference_resnet(model, path):
    """``model``'s weights in the reference trainer's ``.pth.tar``."""
    variables = {"params": to_flax_tree(model),
                 "batch_stats": to_flax_batch_stats(model)}
    save_pth_tar(variables, str(path), epoch=0)
    return str(path)


def _image_folder(root):
    """train/ and val/ with 2 classes of 4 JPEGs of 24-60 px."""
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for c in range(2):
            os.makedirs(root / split / str(c))
            for i in range(4):
                w, h = (int(v) for v in rng.integers(24, 60, 2))
                Image.fromarray(rng.integers(0, 255, (h, w, 3), np.uint8)
                                ).save(root / split / str(c) / f"{i}.jpg")
    return str(root)


@pytest.mark.parametrize("extra", [
    ["--vit_linear", "int8_qat"],
    ["--vit_attn", "fused", "--amp", "--vit_skip", "token,head"],
    ["--optimizer", "RMSprop", "--lr_mult", "0.1"],
    ["--no_decay_biases", "--temp_scheduler", "cosine"]],
    ids=["int8_qat", "fused_amp", "rmsprop", "no_decay_biases"])
def test_train_main_variants(tmp_path, extra):
    best = tmain.main(BASE + ["--epochs", "1", "--train_url", str(tmp_path)]
                      + extra)
    assert np.isfinite(best)
    dens = np.loadtxt(tmp_path / "all_density_latest.txt")
    assert dens.shape == (4, 12)
    if "--vit_skip" in extra:           # no layer gates: densities are 1
        assert (dens[2:] == 1.0).all()


@pytest.mark.parametrize("flags", [
    ["--arch", "uni_resnet50"], ["--arch", "lad_regnet_y_400mf"],
    ["--conv_impl", "int8_qat"], ["--data_url", "IMAGES"],
    ["--finetune_from", "deit.pth"], ["--teacher_path", "deit.pth"],
    ["--tp", "2"], ["--fsdp"], ["--pp", "2"], ["--dist_process_id", "0"],
    ["--autoaugment"]],
    ids=lambda f: f[-2].lstrip("-") if len(f) > 1 else f[0].lstrip("-"))
def test_flags_of_later_slices_raise(tmp_path, flags):
    if flags in (["--arch", "uni_resnet50"], ["--conv_impl", "int8_qat"]):
        # once flags of a later slice: the CNN archs and their QAT now train
        _cnn_run(tmp_path, ["--arch", "uni_resnet50"] + flags)
        return
    if flags == ["--arch", "lad_regnet_y_400mf"]:
        # the RegNet archs train too: the JAX CLI's RegNet smoke run
        # (`tests/test_train_cli.py::test_train_main_regnet_smoke`)
        _regnet_run(tmp_path, flags)
        return
    if flags[0] in ("--data_url", "--autoaugment"):
        # the data slice's flags train: on an image folder, the augmentation
        # through the PIL pipeline
        data = _image_folder(tmp_path / "images")
        argv = BASE + ["--epochs", "1", "--train_url", str(tmp_path / "run"),
                       "--batch_size", "4", "--data_url", data]
        if flags[0] == "--autoaugment":
            argv += flags
        assert np.isfinite(tmain.main(argv))
        log = open(tmp_path / "run" / "train.log").read()
        assert "epoch 0 [1/2]" in log and "val top1" in log
        assert ("input pipeline: PIL" in log) == (flags[0] == "--autoaugment")
        return
    if flags[0] in ("--finetune_from", "--teacher_path"):
        # ... and take a reference DeiT checkpoint (timm names)
        source = tmain.build_training(tmain.parse_args(BASE + ["--seed", "9"]),
                                      log=lambda *_: None).teacher
        deit = _write_timm_deit(source, tmp_path / flags[1])
        best = tmain.main(BASE + ["--epochs", "1", "--train_url",
                                  str(tmp_path / "run"), flags[0], deit])
        assert np.isfinite(best)
        assert "loaded " in open(tmp_path / "run" / "train.log").read()
        os.unlink(deit)
        return
    with pytest.raises(NotImplementedError, match="slice of the port"):
        tmain.main(BASE + ["--train_url", str(tmp_path)] + flags)
    assert not (tmp_path / "train.log").exists()    # refused before writing


CNN_BASE = ["--device", "cpu", "--steps_per_epoch", "2", "--batch_size", "4",
            "--input_size", "32", "--num_classes", "10", "--print_freq", "1"]


def _drop_checkpoints(tmp_path):
    """A ResNet-50 checkpoint with its momentum is 200 MB and pytest keeps
    a test's directory: leave the logs, not the weights."""
    shutil.rmtree(tmp_path / "ckpt")


def _cnn_run(tmp_path, flags, blocks=16, epochs="1", keep=False):
    best = tmain.main(CNN_BASE + ["--epochs", epochs, "--train_url",
                                  str(tmp_path)] + flags)
    assert np.isfinite(best)
    assert (tmp_path / "ckpt" / "step_2.pt").exists()
    if not keep:
        _drop_checkpoints(tmp_path)
    dens = np.loadtxt(tmp_path / "all_density_latest.txt")
    assert dens.shape == (4, blocks)    # s3/s2/s1/channel rows x blocks
    assert ((0 <= dens) & (dens <= 1)).all()
    assert (dens[3] == 1.0).all()       # spatial mode: no channel gates
    with open(tmp_path / "log.txt") as f:
        rows = list(csv.reader(f))
    assert rows[0] == tmain.CSV_HEADER and len(rows) == 1 + int(epochs)
    assert all(np.isfinite(float(v)) for v in rows[-1])
    return dens


def _regnet_run(tmp_path, flags):
    """Channel gates of granularity 2 in every stage, the backbone at a
    tenth of the rate; LAUD-RegNetY-400MF has 16 blocks."""
    best = tmain.main(CNN_BASE + flags + [
        "--dyn_mode", "channel-channel-channel-channel",
        "--channel_dyn_granularity", "2-2-2-2",
        "--channel_masker_layers", "2-2-2-2", "--lr_mult", "0.1",
        "--epochs", "1", "--train_url", str(tmp_path)])
    assert np.isfinite(best)
    _drop_checkpoints(tmp_path)
    dens = np.loadtxt(tmp_path / "all_density_latest.txt")
    assert dens.shape == (4, 16)
    assert (dens[:3] == 1.0).all()      # channel mode: no spatial gates
    assert ((0 <= dens[3]) & (dens[3] <= 1)).all()
    log = open(tmp_path / "train.log").read()
    assert "full_flops (dense multiply-adds)" in log
    with pytest.raises(SystemExit, match="LAUD-ResNet-only"):
        tmain.main(CNN_BASE + flags + ["--conv_impl", "int8_qat",
                                       "--train_url", str(tmp_path / "q")])


def test_train_main_cnn_smoke_resume_and_evaluate(tmp_path):
    _cnn_run(tmp_path, ["--arch", "uni_resnet50", "--amp"], keep=True)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    assert ckpt.latest_step() == 2
    saved = torch.load(tmp_path / "ckpt" / "step_2.pt", weights_only=True)
    # the BatchNorm statistics travel with the parameters, and a step moved
    # them off their initial 0 and 1
    mean = saved["model"]["layer1_0.bn1.running_mean"]
    assert mean.dtype == torch.float32 and mean.abs().max() > 0
    tmain.main(CNN_BASE + ["--arch", "uni_resnet50", "--amp", "--epochs", "2",
                           "--train_url", str(tmp_path)])
    log = open(tmp_path / "train.log").read()
    assert "auto-resumed from step 2" in log and "epoch 1 [0/2]" in log
    assert ckpt.latest_step() == 4
    # the trained weights in the reference trainer's format, evaluated
    args = tmain.parse_args(CNN_BASE + ["--arch", "uni_resnet50"])
    tr = tmain.build_training(args, log=lambda *_: None)
    tr.model.load_state_dict(torch.load(tmp_path / "ckpt" / "step_4.pt",
                                        weights_only=True)["model"])
    ref = _write_reference_resnet(tr.model, tmp_path / "flagship.pth.tar")
    top1 = tmain.main(CNN_BASE + [
        "--arch", "uni_resnet50", "--train_url", str(tmp_path / "eval"),
        "--evaluate_from", ref])
    assert 0.0 <= top1 <= 100.0
    assert top1 == tmain._validate(tr)[0]
    ckpt.close()
    os.unlink(ref)
    _drop_checkpoints(tmp_path)


@pytest.mark.parametrize("flags", [[], ["--arch", "uni_resnet50"]],
                         ids=["vit", "cnn"])
def test_evaluate_from_refuses_the_cli_s_own_checkpoint(tmp_path, flags):
    """``--evaluate_from`` reads reference checkpoints. Given the
    ``step_<n>.pt`` this CLI writes, the converter finds names it does not
    know and raises: no model is evaluated with weights half loaded."""
    base = CNN_BASE if flags else BASE
    tr = tmain.build_training(tmain.parse_args(base + flags),
                              log=lambda *_: None)
    CheckpointManager(str(tmp_path / "ckpt")).save(0, tr.state)
    with pytest.raises((KeyError, ValueError),
                       match="unmapped checkpoint keys|not plain-DeiT"):
        tmain.main(base + flags + ["--train_url", str(tmp_path / "eval"),
                                   "--evaluate_from",
                                   str(tmp_path / "ckpt" / "step_0.pt")])
    assert "evaluate: top1" not in open(tmp_path / "eval" / "train.log").read()
    _drop_checkpoints(tmp_path)


def test_train_main_cnn_channel_modes(tmp_path):
    flags = ["--arch", "uni_resnet50", "--dyn_mode", "both-both-channel-layer",
             "--channel_masker", "MLP-conv_linear-MLP-MLP",
             "--channel_masker_layers", "2-2-1-1",
             "--channel_dyn_granularity", "1-2-1-1", "--optimizer", "RMSprop"]
    best = tmain.main(CNN_BASE + ["--epochs", "1", "--train_url",
                                  str(tmp_path)] + flags)
    _drop_checkpoints(tmp_path)
    assert np.isfinite(best)
    dens = np.loadtxt(tmp_path / "all_density_latest.txt")
    assert dens.shape == (4, 16) and (dens[3, :13] < 1.0).any()


def test_resnet101_builds_with_its_own_teacher_and_flops():
    """`uni_resnet101` is set up (not trained: 33 blocks are slow on the
    CPU): the student, a dense ResNet-101 teacher, and the closed-form
    ``full_flops`` of the JAX CLI."""
    from laudnet_tpu.utils.flops import resnet_full_flops as j_full_flops

    args = tmain.parse_args(CNN_BASE + ["--arch", "uni_resnet101"])
    tr = tmain.build_training(args, log=lambda *_: None)
    assert tr.model.layers == tr.teacher.layers == (3, 4, 23, 3)
    assert sum(len(st) for st in tr.model.stages()) == 33
    assert tr.cfg.full_flops == j_full_flops((3, 4, 23, 3), input_size=32,
                                             num_classes=10)
    assert not any(p.requires_grad for p in tr.teacher.parameters())


def test_density_rows_and_family_checks_are_the_jax_cli_s():
    rng = np.random.default_rng(0)
    stats = {k: tuple(rng.random(n).astype(np.float32) for n in (3, 4, 6, 3))
             for k in ("spatial_s3", "spatial_s2", "spatial_s1", "channel_s")}
    ours = tmain._density_rows({k: tuple(map(torch.from_numpy, v))
                                for k, v in stats.items()})
    np.testing.assert_array_equal(ours, jmain._density_rows(stats))
    assert tmain._stage_list("4-4-2-1", int) == jmain._stage_list(
        "4-4-2-1", int) == (4, 4, 2, 1)
    # the JAX CLI's refusals of a flag on the wrong family
    with pytest.raises(SystemExit, match="--conv_impl applies to"):
        tmain.main(BASE + ["--conv_impl", "int8_qat"])
    with pytest.raises(SystemExit, match="--vit_linear applies to"):
        tmain.main(CNN_BASE + ["--arch", "uni_resnet50", "--vit_linear",
                               "int8_qat"])
    assert tmain.arch_family("uni_resnet101") == "resnet"


def test_flags_and_defaults_are_the_jax_cli_s():
    ours = vars(tmain.parse_args([]))
    theirs = vars(jmain.parse_args([]))
    assert ours.pop("device") is None
    assert ours == theirs
    assert tmain.VIT_ARCHS == jmain.VIT_ARCHS
    assert tmain.arch_family("laud_t2t_vit_19") == "vit"


def test_fused_attention_without_amp_is_refused_on_a_card_only():
    """``--vit_attn fused`` without ``--amp`` is refused nowhere now (the
    kernels take f32 too): it builds and takes one f32 step, and the
    step's metrics equal those of the same step through ``--vit_attn
    reference`` to f32 summation order (the Function's plain forward and
    backward against autograd through the model's own attention)."""
    images, labels = next(tmain.synthetic_batches(8, 32, 10, 1, seed=0))
    metrics = {}
    for attn in ("fused", "reference"):
        args = tmain.parse_args(BASE + ["--vit_attn", attn])
        tr = tmain.build_training(args, log=lambda *_: None)
        x, y = tr.to_device(images, labels)
        metrics[attn] = {k: float(v) for k, v in
                         tr.train_step(tr.state, x, y).items()}
    assert set(metrics["fused"]) == set(metrics["reference"])
    for k, v in metrics["reference"].items():
        assert np.isfinite(metrics["fused"][k]), k
        np.testing.assert_allclose(metrics["fused"][k], v, rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_without_a_device_flag_the_cli_asks_for_cuda(tmp_path):
    """No ``--device``: the card. Without one PyTorch's own error comes
    through; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI would train on it")
    argv = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises((AssertionError, RuntimeError),
                       match="(?i)cuda|nvidia"):
        tmain.main(argv + ["--epochs", "1", "--train_url", str(tmp_path)])


def test_synthetic_batches_and_recipes_match_jax():
    from laudnet_tpu.data import synthetic_batches as jsyn
    from laudnet_tpu.train import hyperparams as jh

    for (a, b), (c, d) in zip(tmain.synthetic_batches(3, 8, 10, 2, seed=4),
                              jsyn(3, 8, 10, 2, seed=4)):
        assert a.dtype == np.float32 and b.dtype == np.int32
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    assert sorted(RECIPES) == sorted(jh.RECIPES)
    for k in RECIPES:
        assert vars(get_hyperparams(k)) == vars(jh.get_hyperparams(k))
    with pytest.raises(KeyError, match="unknown hyperparams_set_index"):
        get_hyperparams(99)


def test_config_file_selects_the_recipe(tmp_path):
    base = tmp_path / "base.py"
    base.write_text("train_cfg = dict(hyperparams_set_index=3)\nnote = 'b'\n")
    child = tmp_path / "child.py"
    child.write_text("_base_ = 'base.py'\nnote = 'c'\n")
    cfg = Config.fromfile(str(child))
    assert cfg.train_cfg.hyperparams_set_index == 3 and cfg.note == "c"
    args = tmain.parse_args(BASE + ["--config", str(child)])
    tr = tmain.build_training(args, log=lambda *_: None)
    assert tr.cfg.base_lr == get_hyperparams(3).lr == 0.08
    assert tr.epochs == 100 and tr.batch_size == 8
    repo_cfg = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "configs", "finetune_100eps_1024bs_lr0x08.py")
    assert Config.fromfile(repo_cfg).train_cfg["hyperparams_set_index"] == 3


def test_checkpoint_manager_keeps_two_and_the_best(tmp_path):
    from laudnet_tpu_torch.train.trainer import TrainState

    def state(step, value):
        lin = torch.nn.Linear(2, 2)
        with torch.no_grad():
            lin.weight.fill_(value)
        opt = torch.optim.SGD(lin.parameters(), lr=0.1, momentum=0.9)
        lin.weight.grad = torch.ones_like(lin.weight)
        opt.step()
        return TrainState(step, lin, opt)

    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(state(0, 0.0))
    mgr.save(1, state(1, 1.0), metadata={"epoch": 0}, is_best=True)
    mgr.save(2, state(2, 2.0), metadata={"epoch": 1})
    mgr.save(3, state(3, 3.0), metadata={"epoch": 2})
    assert mgr.all_steps() == [2, 3]                    # max_to_keep=2
    assert not os.path.exists(tmp_path / "meta_1.json")
    fresh = state(0, 0.0)
    _, meta = mgr.restore(fresh)
    assert fresh.step == 3 and meta == {"epoch": 2}
    assert torch.allclose(fresh.model.weight, torch.full((2, 2), 2.9))
    buf = fresh.optimizer.state_dict()["state"][0]["momentum_buffer"]
    assert torch.equal(buf, torch.ones(2, 2))
    best = state(0, 0.0)
    _, meta = mgr.restore_best(best)                    # survived the GC
    assert best.step == 1 and meta == {"step": 1, "epoch": 0}
    mgr.close()
