"""The output check has to fail what is not correct: the control (the
reference in the precision below the configuration's, in the program's
place) and each fault planted in the timed path. At a tiny size on the
CPU; the same readings at the cells' sizes come from ``control.py`` on the
card (PERF.md gives them)."""

from __future__ import annotations

import pytest
import torch

from bench_tiny import DEIT, RESNET, TRAIN, tiny_run, with_train_cell
from h100_bench import control, faults
from h100_bench import run as R

CELLS = [DEIT, RESNET]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_check(workload):
    """The program, served in float32 here, passes every limit; the fp8
    control fails one at least; so does each planted fault."""
    run = tiny_run(workload, dtype="float32")
    limits = run.config["limits"]["serve"]
    readings = control.readings(run, steps=4)
    for name, limit in limits.items():
        assert readings["program"][name] <= limit, (name, readings)
    for tag in ["control", *faults.SERVED]:
        assert any(readings[tag][k] > limit for k, limit in limits.items()
                   if k in readings[tag]), (tag, readings[tag])


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.SERVED))
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    """A whole run, past the look for a card, with the serving entry broken
    underneath: ``correct`` comes out false and the images are counted as
    failed."""
    run = tiny_run(workload, dtype="float32")
    build = run.program.build_serve
    monkeypatch.setattr(run.program, "build_serve", lambda r, w: (
        faults.broken_serve(build(r, w), faults.SERVED[fault])))
    result = R.execute(run)
    assert result["correct"] is False
    assert 0 < result["failed"] <= result["attempted"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_float32_run_is_correct(workload):
    result = R.execute(tiny_run(workload, dtype="float32"))
    assert result["correct"] is True and result["failed"] == 0


def test_served_errors_reads_a_wrong_shape_as_infinite():
    from h100_bench import compare

    ref = torch.ones(4, 10)
    rel, per_image, n = compare.served_errors([(0, torch.ones(2, 10))],
                                              [ref])
    assert rel == float("inf") and n == 4
    assert torch.isinf(per_image).all()


def _tiny_train_run():
    run = tiny_run(TRAIN, dtype="float32",
                   bench=with_train_cell(R.load_json(R.BENCHMARK)))
    run.traffic.update(mode="train", batch=4, pool=4, checked_steps=3,
                       warmup_steps=1, trace_steps=2)
    # a gentle step, so that three of them stay where float32's order of
    # summation moves nothing
    run.config["train"] = dict(run.config["train"], base_lr=0.002)
    return run


def test_train_faults_fail_the_check():
    """The training step passes its limits and each planted fault fails
    one. The float8 control fails none of them on the card (PERF.md), so
    the training cell is not in BENCHMARK.json yet."""
    run = _tiny_train_run()
    limits = run.config["limits"]["train"]
    readings = control.train_readings(run)
    for name, limit in limits.items():
        assert readings["program"][name] <= limit, (name, readings)
    for tag in faults.TRAIN:
        assert any(readings[tag][k] > limit for k, limit in limits.items()),\
            (tag, readings[tag])


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_a_broken_training_step_is_not_correct(fault, monkeypatch):
    run = _tiny_train_run()
    build = run.program.build_train
    monkeypatch.setattr(run.program, "build_train", lambda *a: (
        lambda step, state: (faults.TRAIN[fault](step), state))(*build(*a)))
    result = R.execute(run)
    assert result["correct"] is False and result["failed"] > 0


def test_a_sound_float32_training_run_is_correct():
    result = R.execute(_tiny_train_run())
    assert result["correct"] is True, result["checks"]
