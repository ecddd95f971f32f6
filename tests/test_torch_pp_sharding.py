"""ZeRO stages 1-3 under every pipeline schedule in the port against the
JAX package's pipelined step, on the CPU (`torch_zero_pp.py` says how
both sides run).

The port: four gloo ranks at pp 2 x sharding 2 build LLaMA at their stage
from the reference's full numpy state and step through
`build_train_step(..., sharding_stage=s)` under "1f1b", "gpipe" and "vpp"
(v = 2), s = 1, 2, 3; each rank passes its shard of the batch over
"sharding". The reference's stage is a layout of one compiled program:
its 1F1B step at stages 1, 2 and 3 gives the same losses and parameters
bit for bit (held here), so its GPipe and VPP steps run at stage 2 and
every port stage of a schedule is held to its schedule's run.

Held: 3 steps' losses bit-equal on every rank and within rtol 2e-4,
atol 2e-5 of the reference's; every parameter after the last step (the
stages and stage-3 pieces joined by `weights.gather_llama_state`) within
3e-5 of the reference's, its difference over its norm; exactly one
reduce_scatter a bucket a step on every rank (never M); the update once a
piece of the rank's slice; the clip's global norm from the slices equal
to stage 0's; an inf in one rank's gradient slice on one stage skipping
the step on every rank.
"""
import numpy as np
import pytest

import torch_zero_pp as Z
from torch_pp_workers import pp_runs_main, start_groups

RUNS = {f"s{s}_{sched}": (Z.PP2_S2, sched, 2 if sched == "vpp" else 1, s,
                          "llama", "step")
        for s in (1, 2, 3) for sched in ("1f1b", "gpipe", "vpp")}
# the reference runs: 1F1B at every stage, the others at stage 2
REF = {tag: (tag if spec[1] == "1f1b" else f"s2_{spec[1]}")
       for tag, spec in RUNS.items()}


@pytest.fixture(scope="module")
def started():
    """The group of 4 ranks, started in the background: the reference
    runs meanwhile."""
    states = Z.states()
    x, y = Z.batch()
    clip = [(f"clip_s{s}", "zero_pp_clip", dict(
        state=states["llama"], x=x, y=y, M=Z.M, stage=s)) for s in (1, 3)]
    return start_groups(pp_runs_main, {4: Z.port_runs(RUNS, 4, states,
                                                      clip)})


@pytest.fixture(scope="module")
def reference(started):
    return {tag: Z.jax_run(RUNS[tag]) for tag in sorted(set(REF.values()))}


@pytest.fixture(scope="module")
def ranks(started, reference):
    """[rank results] of the group."""
    return started()[4]


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_zero_under_the_pipeline_matches_the_reference(ranks, reference,
                                                       tag):
    Z.check_run(RUNS[tag], [r[tag] for r in ranks], reference[REF[tag]])


def test_the_reference_s_stages_are_one_program(reference):
    """Why one reference run a schedule holds every port stage: its 1F1B
    step at stages 1-3 gives equal losses and parameters, bit for bit."""
    l1, s1 = reference["s1_1f1b"]
    for tag in ("s2_1f1b", "s3_1f1b"):
        l, st = reference[tag]
        assert l == l1
        for k, v in s1.items():
            np.testing.assert_array_equal(st[k], v)


@pytest.mark.parametrize("stage", [1, 3])
def test_clip_norm_and_inf_skip_span_the_stages_and_slices(ranks, stage):
    """The clip's global norm from the rank's slices (summed over
    "sharding" and "pp") equals stage 0's, from the whole gradients; an inf
    in one rank's slice on the last stage skips the step on every rank and
    halves the scale."""
    for r in ranks:
        got = r[f"clip_s{stage}"]
        assert got["norm"] is not None
        np.testing.assert_allclose(got["norm"], got["want"], rtol=1e-5)
        assert got["skipped"] and got["scale"] == 512.0


def test_sharding_configs_are_the_reference_s():
    """`DistributedStrategy.sharding_configs` beyond the degree: the
    reference reads none of them (its stage is the optimizer's or the
    step's), so the port keeps the same inert dict."""
    from paddle_tpu.distributed.fleet import DistributedStrategy as JDS
    from paddle_tpu_torch.distributed.fleet import DistributedStrategy

    assert DistributedStrategy().sharding_configs == JDS().sharding_configs
    assert DistributedStrategy().sharding is JDS().sharding is False
