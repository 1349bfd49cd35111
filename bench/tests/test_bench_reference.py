"""The plain references (bench/reference/) against the port's train step
at reduced sizes on the CPU: in float32 the first three steps' losses,
the first gradient and each leaf's change over the three agree to
rounding; in the configuration's bf16 the program reads small gaps, and
the control (the reference computed in float8 in the program's place)
reads larger ones."""
import pytest
import torch

from bench.tests._tiny import tiny_job
from bench.harness import check, train
from bench.reference import common

CELLS = ["bert-large.p1-seq128", "bert-large.p2-seq512",
         "granite-moe-3b-a800m-16l.pretrain-seq4096"]
SEED = 2 ** 31 + 7
CPU = torch.device("cpu")


def readings(job):
    run = train.Run(job, SEED, CPU)
    prog = run.first_steps()
    pool = run.pool_np
    run.free()
    return prog, pool


def numbers(job, side, ref):
    side["grad_diff"] = train.grad_diffs(side, ref, CPU)
    return check.numbers(side, ref, dense=train.dense(job.conf))


@pytest.mark.parametrize("cell", CELLS)
def test_reference_follows_the_program_in_float32(cell):
    torch.set_num_threads(2)
    job = tiny_job(cell, fp32=True)
    prog, pool = readings(job)
    ref = train.reference_readings(job, SEED, CPU, pool)
    n = numbers(job, prog, ref)
    assert n["loss"]["value"] < 1e-6
    assert n["grad"]["worst"] < 1e-5
    assert n["grad_dir"]["value"] < 1e-5
    assert n["change"]["worst"] < 1e-5


@pytest.mark.parametrize("cell", [CELLS[0], CELLS[2]])
def test_the_control_reads_above_the_program(cell):
    torch.set_num_threads(2)
    job = tiny_job(cell)
    prog, pool = readings(job)
    ref = train.reference_readings(job, SEED, CPU, pool)
    ctl = train.reference_readings(job, SEED, CPU, pool, common.FP8)
    p, c = numbers(job, prog, ref), numbers(job, ctl, ref)
    assert c["loss1"]["value"] > 3 * p["loss1"]["value"]
    assert c["grad"]["value"] > 3 * p["grad"]["value"]
    assert c["grad_dir"]["value"] > 3 * p["grad_dir"]["value"]
