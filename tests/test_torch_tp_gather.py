"""The "gather" route of the sharded train step (``lm.step_route(cfg) ==
"gather"``: the whole model gathered once per step and run whole on every
rank) against the JAX reference on the CPU, for the families that keep
it: the Mamba2, Zamba2 and Whisper smoke configs, float32, 3 steps of
4 x 64 on the meshes (data, model) = (1, 4) and (2, 2), the port on 4
gloo ranks and the reference's ``train(mesh=)`` on 4 virtual XLA devices;
the harness is ``_torch_tp``'s."""
import pytest

from repro_torch import configs as tconfigs
from repro_torch.models import lm

import _torch_parity  # noqa: F401  (pins torch to one thread)
import _torch_tp as tp
from test_torch_ranks import RankPool

CASES = (("mamba2", "mamba2_130m", {}),
         ("zamba2", "zamba2_7b", {}),
         ("whisper", "whisper_small", {}))
CASE_MESH = [(c, s) for c in CASES for s in tp.MESHES]
#: Zamba2's step-3 loss and final parameters.  Its SSD's float32
#: gradients agree with the reference's within GRAD_RTOL of each leaf's
#: max (test_step1_grads_match_reference; the widest of the smoke
#: configs, see test_torch_lm_train), and AdamW's steps take their signs,
#: so three steps spread even the reference's own runs: its step-3 loss
#: by 1.1e-5 over its meshes (none, (1, 4), (2, 2), (4, 1)) and its final
#: parameters on (1, 4) by 1.5e-4 from its one-device run (the entries
#: kept under SIGN_FRAC).  The port's one-process run sits 2.5e-5 (loss)
#: and 4.0e-4 (parameters) from the reference's one-device run, and its
#: runs on the meshes 1.4e-5 and 2.1e-5 (loss) and up to 2.4e-4
#: (parameters, one entry of the shared attention's wq) from the
#: reference's on the same mesh: the gap is the one-process gap, not the
#: mesh's.  Steps 1 and 2 stay at LOSS_TOL.  8.3% of its entries have a
#: step-1 gradient below SIGN_FRAC of their leaf's max (the SSM's), so the
#: share left out is held under 0.1
ZAMBA2 = dict(tols=(tp.LOSS_TOL, tp.LOSS_TOL, 5e-5), param_tol=5e-4,
              left_out_frac=0.1)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference(CASES, tmp_path_factory.mktemp("tp_gather_ref"))


@pytest.fixture(scope="module")
def runs():
    pool = RankPool(4)
    try:
        yield tp.run_port(pool, CASES)
    finally:
        pool.close()


@pytest.mark.parametrize("case,shape", CASE_MESH, ids=tp.ids)
def test_gather_step_matches_reference(reference, runs, case, shape):
    """Every step's loss within LOSS_TOL of the reference's on the same
    mesh on every rank; the final parameters within PARAM_TOL (Zamba2
    within ZAMBA2's bounds)."""
    tp.check_losses_and_params(reference, runs[case[0], shape], case[0],
                               shape, **(ZAMBA2 if case[0] == "zamba2"
                                         else {}))


@pytest.mark.parametrize("case,shape", CASE_MESH, ids=tp.ids)
def test_step1_grads_match_reference(reference, runs, case, shape):
    """One step's gradients, gathered whole, equal the reference's
    ``jax.grad`` of the same batch within float32 across the libraries."""
    tp.check_step1_grads(reference, runs[case[0], shape], case[0], shape)


@pytest.mark.parametrize("case,shape", CASE_MESH, ids=tp.ids)
def test_blocks_shaped_as_reference_shards(reference, runs, case, shape):
    """Each rank's parameter and gradient blocks are the reference's
    shards."""
    tp.check_block_shapes(reference, runs[case[0], shape], case[0],
                          case[1], case[2], shape)


@pytest.mark.parametrize("case,shape", CASE_MESH, ids=tp.ids)
def test_census_is_the_whole_model_gather(runs, case, shape):
    """The route is named "gather", and one step's all-gathers are the
    whole-model gather's, exactly."""
    cfg = tconfigs.get_smoke(case[1]).with_(**case[2])
    assert lm.step_route(cfg) == "gather"
    tp.check_gather_census(runs[case[0], shape], case[1], case[2], shape)
