"""ZeRO under the pipeline through its other routes and geometries, in the
port against the JAX package's pipelined step, on the CPU
(`torch_zero_pp.py` says how both sides run): pp 2 x sharding 2 x tp 2 on
eight gloo ranks at stage 2; GPT with its embedding tied over the first
and last stages at stage 2 (`build_train_step`) and stage 3
(`group_sharded_parallel` first, so the tied weight's slices are
broadcast); `fleet.distributed_model` (PipelineParallel) with
`fleet.distributed_optimizer` (stage 1) or `group_sharded_parallel`
(stage 2) and `train_batch`; `jit.train_step` at stage 3. The reference's
stage is a layout (`tests/test_torch_pp_sharding.py` holds its stages
bit-equal), so GPT's stage-3 run and the LLaMA routes are held to its
stage-2 steps.

Held as there (losses, parameters, one reduce_scatter a bucket a step,
one update a piece), and the tied embedding's two copies equal after the
steps.
"""
import numpy as np
import pytest

import torch_zero_pp as Z
from torch_pp_workers import pp_runs_main, start_groups

RUNS = {
    "s2_tp2": (dict(pp=2, sharding=2, tp=2), "1f1b", 1, 2, "llama", "step"),
    "gpt_s2": (Z.PP2_S2, "1f1b", 1, 2, "gpt", "step"),
    "gpt_s3": (Z.PP2_S2, "1f1b", 1, 3, "gpt", "gsp"),
    "fleet_s1": (Z.PP2_S2, "1f1b", 1, 1, "llama", "fleet"),
    "fleet_s2": (Z.PP2_S2, "1f1b", 1, 2, "llama", "fleet"),
    "jit_s3": (Z.PP2_S2, "1f1b", 1, 3, "llama", "jit"),
}
REF = {"s2_tp2": "s2_tp2", "gpt_s2": "gpt_s2", "gpt_s3": "gpt_s2",
       "fleet_s1": "s2_1f1b", "fleet_s2": "s2_1f1b", "jit_s3": "s2_1f1b"}
SPECS = dict(RUNS, s2_1f1b=(Z.PP2_S2, "1f1b", 1, 2, "llama", "step"))


@pytest.fixture(scope="module")
def started():
    """One group of 4 ranks and one of 8, started in the background: the
    reference runs meanwhile."""
    states = Z.states()
    return start_groups(pp_runs_main, {n: Z.port_runs(RUNS, n, states)
                                       for n in (4, 8)})


@pytest.fixture(scope="module")
def reference(started):
    return {tag: Z.jax_run(SPECS[tag]) for tag in sorted(set(REF.values()))}


@pytest.fixture(scope="module")
def ranks(started, reference):
    """{world: [rank results]}."""
    return started()


@pytest.mark.parametrize("tag", sorted(RUNS))
def test_zero_route_matches_the_reference(ranks, reference, tag):
    spec = RUNS[tag]
    Z.check_run(spec, [r[tag] for r in ranks[Z.world(spec[0])]],
                reference[REF[tag]])


def test_the_tied_embedding_copies_stay_equal(ranks):
    """GPT's embedding on the first and the last stage: sliced alike over
    "sharding", its gradient slices summed over the two stages, so the
    copies (stage-3 pieces too) are equal after the steps."""
    for tag in ("gpt_s2", "gpt_s3"):
        holders = {}
        for r in (r[tag] for r in ranks[4]):
            st = r["state"]
            name = "gpt.embed_tokens.weight"
            key = tuple(st["@zero"]["pieces"][name][:2]) if "@zero" in st \
                else "whole"
            holders.setdefault(key, []).append((r["stage"], st[name]))
        for copies in holders.values():
            assert {s for s, _ in copies} == {0, 1}
            for _, a in copies[1:]:
                np.testing.assert_array_equal(a, copies[0][1])
