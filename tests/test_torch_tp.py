"""Tensor parallelism over ``"model"`` in the sharded train step (the
"split" route, ``repro_torch.models.parallel``) against the JAX
reference on the CPU, for the dense and vlm families: the h2o-danube,
gemma2 and chameleon smoke configs, danube's with one kv head of two
query heads, and danube's and gemma2's with vocabulary shards made only
of padded lanes, float32, 3 steps of 4 x 64 on the meshes (data, model)
= (1, 4) and (2, 2), the port on 4 gloo ranks
(``test_torch_ranks.RankPool``) and the reference's ``train(mesh=)`` on 4
virtual XLA devices (``_torch_tp``).  The MoE family is in
``test_torch_tp_moe.py``, the ssm, hybrid and audio families in
``test_torch_tp_ssm.py``.

Also here: each autograd collective of ``models.parallel`` on 4 ranks,
forward and backward, against the one-process math; the share of a
rank's matmul flops on (1, 4); the dry run's count of the same step; the
per-layer gathers per micro-batch against the reference's compiled
loops; and, against one process as an extra check, the padded
vocabulary shards and the ssm, hybrid and audio families."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.launch import dryrun as D
from repro_torch.models import lm
from repro_torch.train import optim
from repro_torch.train.data import make_source

import _torch_parity  # noqa: F401  (pins torch to one thread)
import _torch_tp as tp
import test_torch_ranks as td
from test_torch_ranks import RankPool

#: "mqa": danube smoke with 2 query heads and 1 kv head of 32: on (1, 4)
#: the heads do not split, so the attention runs whole on every rank
#: (its leaves, sharded over "model" by the rules, gathered whole); on
#: (2, 2) each rank has one query head and reads the one kv head.
#: "danube_pad", "gemma2_pad": a vocabulary of 100 padded to 256 lanes, so
#: on (1, 4) ranks 2 and 3 hold only padded lanes of the embedding, the
#: head and the loss (gemma2: its final softcap per shard)
CASES = (("danube", "h2o_danube_1p8b", {}),
         ("gemma2", "gemma2_27b", {}),
         ("chameleon", "chameleon_34b", {}),
         ("mqa", "h2o_danube_1p8b", {"n_heads": 2, "n_kv": 1,
                                     "head_dim": 32}),
         ("danube_pad", "h2o_danube_1p8b", {"vocab": 100}),
         ("gemma2_pad", "gemma2_27b", {"vocab": 100}))
#: "mqa" on (1, 4) reads its attention leaves whole: a quarter of the
#: whole-model gather crosses "model" (the MLP and vocabulary still split)
MQA_WHOLE_SHARE = 0.3
#: a rank's matmul flops on (1, 4) against one process's, danube smoke:
#: its query heads, the one kv head they read of two, its d_ff columns
#: and vocabulary rows (0.27 by count)
FLOP_SHARE = 0.40


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return tp.run_reference(CASES, tmp_path_factory.mktemp("tp_ref"))


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def runs(pool):
    return tp.run_port(pool, CASES)


CASE_MESH = [(c, s) for c in CASES for s in tp.MESHES]


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
    shards."""
    tp.check_block_shapes(reference, runs[case[0], shape], case[0],
                          case[1], case[2], shape)


@pytest.mark.parametrize("case,shape", CASE_MESH, ids=tp.ids)
def test_norm_grads_equal_on_every_model_rank(runs, case, shape):
    """The norm scales' gradients (and chameleon's qk-norm's) are bit-equal
    on every rank of a model team."""
    tp.check_norm_grads_equal(runs[case[0], shape])


@pytest.mark.parametrize("case,shape", CASE_MESH, ids=tp.ids)
def test_census_has_no_whole_model_gather(runs, case, shape):
    """One step's collectives: no whole-model gather (the model team's
    all-gathers a tenth of it at most), FSDP gathers over "data", the
    activations' all-reduces over "model"."""
    share = (MQA_WHOLE_SHARE if (case[0], shape) == ("mqa", (1, 4))
             else tp.MODEL_GATHER_SHARE)
    tp.check_census(runs[case[0], shape], case[1], case[2], shape, share)


def _one_process_flops(name) -> int:
    cfg = tconfigs.get_smoke(name).with_(dtype="float32")
    model = convert.lm_params_from_numpy(cfg, tp.weights(name, {}),
                                         device="cpu")
    model.requires_grad_(True)
    batch = make_source(cfg, tp.SEQ, tp.BATCH, 0, "cpu")(0)
    with FlopCounterMode(display=False) as fc:
        optim.accumulate_gradients(lambda p, b: lm.loss_fn(cfg, p, b),
                                   model, batch, 1)
    return fc.get_total_flops()


def test_rank_flops_share_and_the_dry_run_count(runs):
    """danube smoke on (1, 4): each rank's matmul flops at most FLOP_SHARE
    of one process's over the same batch, and rank 0's count equal to the
    dry run's for rank 0 of a fake (1, 4) mesh (route "split")."""
    one = _one_process_flops("h2o_danube_1p8b")
    res = runs["danube", (1, 4)]
    assert len({r["flops"] for r in res}) == 1
    assert 0 < res[0]["flops"] <= FLOP_SHARE * one, (res[0]["flops"], one)
    cfg = tconfigs.get_smoke("h2o_danube_1p8b").with_(dtype="float32")
    cnt = D.trace_step(cfg, "train", tp.BATCH, tp.SEQ, mesh_shape=(1, 4),
                       mesh_axes=("data", "model"), device="cpu")
    assert cnt["route"] == "split"
    assert cnt["flops"] == res[0]["flops"]


#: the layer schedule: danube smoke at 3 layers in 2 micro-batches under
#: remat (the full configs' setting), a batch of 8 x 64, on meshes with
#: an FSDP axis: a model team of one rank and one of two
SCHEDULE = {"n_layers": 3, "n_micro": 2, "remat": True}
SCHEDULE_MESHES = ((4, 1), (2, 2))


@pytest.fixture(scope="module")
def schedule():
    return tp.reference_loop_gathers("h2o_danube_1p8b", SCHEDULE,
                                     SCHEDULE_MESHES, 8, tp.SEQ)


@pytest.mark.parametrize("shape", SCHEDULE_MESHES, ids=tp.key)
def test_gathers_each_layer_per_micro_batch_as_the_reference(schedule,
                                                             shape):
    """The reference's compiled step gathers each layer's weights in its
    layer loops (forward and backward), which sit inside its micro-batch
    loop: so it gathers again in every micro-batch, whatever the model
    team's size.  The split route does the same: the same number of
    all-gathers per layer and micro-batch (the dry run's count on a fake
    mesh), and every one of its all-gathers recurs per micro-batch."""
    loops = schedule[tp.key(shape)]
    micro = [lp for lp in loops if lp[0] == SCHEDULE["n_micro"]]
    layer = [lp for lp in loops if lp[0] == SCHEDULE["n_layers"]]
    assert len(micro) == 1 and micro[0][1] == len(layer) == 2, loops
    per_layer = sum(n for _, _, n in layer)
    assert per_layer > 0

    def count(n_layers, n_micro):
        cfg = tconfigs.get_smoke("h2o_danube_1p8b").with_(
            dtype="float32", **dict(SCHEDULE, n_layers=n_layers,
                                    n_micro=n_micro))
        cnt = D.trace_step(cfg, "train", 8, tp.SEQ, mesh_shape=shape,
                           mesh_axes=("data", "model"), device="cpu")
        assert cnt["route"] == "split"
        return cnt["colls"].counts["all-gather"]

    n, layers = SCHEDULE["n_micro"], SCHEDULE["n_layers"]
    assert count(layers + 1, n) - count(layers, n) == n * per_layer
    assert count(layers, n) == n * count(layers, 1)


#: CASES' vocabularies of 100 padded to 256 lanes: on (1, 4) ranks 2 and
#: 3 hold only padded lanes of the head and the loss
PADDED = [(name, over) for case, name, over in CASES
          if case.endswith("_pad")]


@pytest.mark.parametrize("name,over", PADDED, ids=[p[0] for p in PADDED])
def test_vocab_shards_of_padding_only(pool, name, over):
    """The vocabulary-parallel head and loss on (1, 4) with two ranks'
    lanes all padding (gemma2: a final softcap per shard), held against
    the reference in the tests above (cases "danube_pad", "gemma2_pad")
    and here, as an extra, against one process: the loss and every
    gradient finite and equal to one process's within float32 summation
    order."""
    cfg = tconfigs.get_smoke(name).with_(dtype="float32", **over)
    assert cfg.vocab_pad // 4 * 2 >= cfg.vocab
    _check_one_process(cfg, pool.run(td.tp_grads, name, over, (1, 4),
                                     tp.SEQ, tp.BATCH))


def _check_one_process(cfg, res):
    """Every rank's loss and rank 0's whole gradients (``tp_grads``) finite
    and equal to one process's within float32 summation order: the loss
    to 1e-6 relative, each leaf to 1e-5 of its max |g| (at least 1)."""
    from repro_torch.models import transformer
    model = transformer.init_params(cfg, seed=0, max_len=tp.SEQ,
                                    device="cpu")
    model.requires_grad_(True)
    batch = make_source(cfg, tp.SEQ, tp.BATCH, 0, "cpu")(0)
    (loss, _), grads = optim.accumulate_gradients(
        lambda p, b: lm.loss_fn(cfg, p, b), model, batch, 1)
    assert all(np.isfinite(r["loss"]) for r in res)
    np.testing.assert_allclose([r["loss"] for r in res], float(loss),
                               rtol=1e-6)
    got = optim.tree_leaves(res[0]["grads"])
    want = optim.tree_leaves(grads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w.numpy(), rtol=0,
                                   atol=1e-5 * max(1.0, float(
                                       w.abs().max())))


#: the ssm, hybrid and audio families (held against the reference in
#: test_torch_tp_ssm.py), Mamba2 also with two B / C groups
SSM_FAMILIES = [("mamba2_130m", {}), ("mamba2_130m", {"ssm_ngroups": 2}),
                ("zamba2_7b", {}), ("whisper_small", {})]


@pytest.mark.parametrize("name,over", SSM_FAMILIES,
                         ids=["mamba2", "mamba2_g2", "zamba2", "whisper"])
def test_split_route_families_on_a_mesh(pool, name, over):
    """The ssm, hybrid and audio families split over the model team (the
    SSM by heads, the shared block's and Whisper's attention and MLP as
    the decoders'): on (2, 2) the batch team's mean loss and every
    gradient, gathered whole, equal one process's within float32
    summation order."""
    cfg = tconfigs.get_smoke(name).with_(dtype="float32", **over)
    _check_one_process(cfg, pool.run(td.tp_grads, name, over, (2, 2),
                                     tp.SEQ, tp.BATCH))


# ---------------------------------------------------------------------------
# the autograd collectives
# ---------------------------------------------------------------------------

#: (op, gathered or split dimension, forward / backward primitives on gloo)
OPS = [("copy_to", None, [], ["psum"]),
       ("reduce_from", None, ["psum"], []),
       ("gather_from", 1, ["all_gather"], ["psum"]),
       ("scatter_to", 1, ["psum"], ["all_gather"]),
       ("gather_whole", 0, ["all_gather"], []),
       ("block_of", 1, [], ["all_gather"])]
TEAMS = [("model",), ("data",), ("data", "model")]


def _expected(op, dim, members, at, x, dy, r):
    """One rank's output and input gradient in one process's math."""
    team_x = [x[m] for m in members]
    team_dy = [dy[m] for m in members]
    n = len(members)
    if op == "copy_to":
        return x[r], sum(team_dy)
    if op == "reduce_from":
        return sum(team_x), dy[r]
    if op == "gather_from":
        return (np.concatenate(team_x, axis=dim),
                np.split(sum(team_dy), n, axis=dim)[at])
    if op == "scatter_to":
        return (np.split(sum(team_x), n, axis=dim)[at],
                np.concatenate(team_dy, axis=dim))
    if op == "block_of":
        return (np.split(x[r], n, axis=dim)[at],
                np.concatenate(team_dy, axis=dim))
    return (np.concatenate(team_x, axis=dim),
            np.split(dy[r], n, axis=dim)[at])


@pytest.mark.parametrize("axes", TEAMS, ids="+".join)
@pytest.mark.parametrize("op,dim,fwd,bwd", OPS, ids=[o[0] for o in OPS])
def test_autograd_collective_matches_one_process(pool, op, dim, fwd, bwd,
                                                 axes):
    """Each collective of ``models.parallel`` over a team of the (2, 2)
    mesh: every rank's output and input gradient equal the one-process
    math (sums in team order, float64), and the primitives it announces
    forward and backward are the ones its docstring names (gloo's
    reduce-scatter is an all-reduce)."""
    rng = np.random.default_rng(len(op) + len(axes))
    n = 4 if axes == ("data", "model") else 2
    block = (3, 2 * n)
    whole = (3 * n, 2 * n) if dim == 0 else (3, 2 * n * n)
    if op in ("gather_from", "gather_whole"):
        x = rng.standard_normal((4,) + block)
        dy = rng.standard_normal((4,) + whole)
    elif op in ("scatter_to", "block_of"):
        x = rng.standard_normal((4,) + whole)
        dy = rng.standard_normal((4,) + block)
    else:
        x = rng.standard_normal((4,) + block)
        dy = rng.standard_normal((4,) + block)
    res = pool.run(td.tp_collective, (2, 2), op, axes, dim, x, dy)
    for r, got in enumerate(res):
        members = got["members"]
        assert len(members) == n and r in members
        want_out, want_grad = _expected(op, dim, members, members.index(r),
                                        x, dy, r)
        np.testing.assert_allclose(got["out"], want_out, rtol=1e-15,
                                   atol=1e-15)
        np.testing.assert_allclose(got["grad"], want_grad, rtol=1e-15,
                                   atol=1e-15)
        assert got["fwd"] == fwd and got["bwd"] == bwd


def test_one_member_teams_are_the_identity():
    """Outside a process group every team has one member: each collective
    returns its input itself, with no autograd node."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import parallel
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    x = torch.ones(2, 3, requires_grad=True)
    for op, dim, _, _ in OPS:
        extra = () if dim is None else (dim,)
        assert getattr(parallel, op)(x, mesh, ("model",), *extra) is x
