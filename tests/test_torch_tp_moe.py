"""Expert parallelism over ``"model"`` in the sharded train step (the
"split" route's MoE, ``repro_torch.models.parallel``) against the JAX
reference on the CPU: the OLMoE smoke config under its "ep" sharding
and under a "tp" override, and the mixtral smoke config under
"ep_virtual", float32, 3 steps of 4 x 64 on the meshes (data, model) =
(1, 4) and (2, 2); the harness is ``_torch_tp``'s.  On (2, 2) the MoE
also dispatches per data shard, as the reference's does."""
import pytest

import _torch_parity  # noqa: F401  (pins torch to one thread)
import _torch_tp as tp
from test_torch_ranks import RankPool

CASES = (("olmoe_ep", "olmoe_1b_7b", {}),
         ("olmoe_tp", "olmoe_1b_7b", {"expert_sharding": "tp"}),
         ("mixtral", "mixtral_8x22b", {}))
CASE_MESH = [(c, s) for c in CASES for s in tp.MESHES]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference(CASES, tmp_path_factory.mktemp("tp_moe_ref"))


@pytest.fixture(scope="module")
def runs():
    pool = RankPool(4)
    try:
        yield tp.run_port(pool, CASES)
    finally:
        pool.close()


@pytest.mark.parametrize("case,shape", CASE_MESH, ids=tp.ids)
def test_split_step_matches_reference(reference, runs, case, shape):
    """Every step's loss within LOSS_TOL of the reference's on the same
    mesh on every rank; the final parameters within PARAM_TOL."""
    tp.check_losses_and_params(reference, runs[case[0], shape], case[0],
                               shape)


@pytest.mark.parametrize("case,shape", CASE_MESH, ids=tp.ids)
def test_step1_grads_match_reference(reference, runs, case, shape):
    """One step's gradients, gathered whole, equal the reference's
    ``jax.grad`` of the same batch within float32 across the libraries."""
    tp.check_step1_grads(reference, runs[case[0], shape], case[0], shape)


@pytest.mark.parametrize("case,shape", CASE_MESH, ids=tp.ids)
def test_blocks_shaped_as_reference_shards(reference, runs, case, shape):
    """Each rank's parameter and gradient blocks are the reference's
    shards: under "ep" E / m experts each, under "tp" d_ff_expert / m."""
    tp.check_block_shapes(reference, runs[case[0], shape], case[0],
                          case[1], case[2], shape)


@pytest.mark.parametrize("case,shape", CASE_MESH, ids=tp.ids)
def test_norm_grads_equal_on_every_model_rank(runs, case, shape):
    """The norm scales' gradients are bit-equal on every rank of a model
    team."""
    tp.check_norm_grads_equal(runs[case[0], shape])


@pytest.mark.parametrize("case,shape", CASE_MESH, ids=tp.ids)
def test_census_has_no_whole_model_gather(runs, case, shape):
    """One step's collectives: no whole-model gather; under "ep" the
    experts' outputs and the dispatch buffer's gradient gathered over
    "model", under "tp" the combine's partial sums all-reduced (no
    all-to-all: every rank of a data shard already holds its tokens)."""
    tp.check_census(runs[case[0], shape], case[1], case[2], shape)
    assert not any(e[0] == "all_to_all" for r in runs[case[0], shape]
                   for e in r["events"])
