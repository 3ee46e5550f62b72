"""Prefill and decode on a mesh for the dense, vlm and MoE families
(``lm.make_prefill`` / ``make_decode_step`` with ``mesh=``: the cached
attention on this rank's blocks of the ring, split by kv heads over
"model" or by slots over the axes of its ``kv_seq`` entry) against the
JAX reference's sharded program on the CPU: the danube, gemma2, qwen2.5,
chameleon, OLMoE and mixtral smoke configs and danube with a chunked
prefill (a 32-token prompt in two 16-token segments against a 48-slot
ring), float32, a 30-token prompt and 4 decode steps (crossing the
32-slot rings) on the meshes (data, model) = (1, 4) and (2, 2) at global
batches of 4 and 1, the port on 4 gloo ranks and the reference on 4
virtual XLA devices; the harness is ``_torch_tp_serve``'s.

The layouts the cases meet (the reference's ``cache_shardings``): on
(1, 4) the 2 kv heads of danube, gemma2, qwen2.5, chameleon and mixtral
do not split over 4, so each rank holds 8 of the 32 slots of every kv
head and the softmax combines over "model"; on (2, 2) at B 4 the kv heads
split over "model" and the rows over "data"; at B 1 the kv heads split
over "model" and the slots over "data"; OLMoE's 4 kv heads split over
"model" on both meshes.
"""
import pytest

import _torch_parity  # noqa: F401  (pins torch to one thread)
import _torch_tp_serve as ts
from test_torch_ranks import RankPool

CASES = (("danube", "h2o_danube_1p8b", {}, 32, 30),
         ("danube_chunked", "h2o_danube_1p8b", {"prefill_chunk": 16}, 48,
          32),
         ("gemma2", "gemma2_27b", {}, 32, 30),
         ("qwen2p5", "qwen2p5_3b", {}, 32, 30),
         ("chameleon", "chameleon_34b", {}, 32, 30),
         ("olmoe", "olmoe_1b_7b", {}, 32, 30),
         ("mixtral", "mixtral_8x22b", {}, 32, 30))
CMB = ts.cases_mesh_batch(CASES)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return ts.run_reference(CASES, tmp_path_factory.mktemp("tp_serve_ref"))


@pytest.fixture(scope="module")
def runs(reference):
    pool = RankPool(4)
    try:
        yield ts.run_port(pool, CASES, reference)
    finally:
        pool.close()


@pytest.mark.parametrize("case,shape,batch", CMB, ids=ts.ids)
def test_prefill_logits_match_reference(reference, runs, case, shape,
                                        batch):
    """Prefill's last logits, gathered from every rank's block, within
    TOL of the reference's."""
    ts.check_logits(reference, runs[case[0], shape, batch], case[0], shape,
                    batch)


@pytest.mark.parametrize("case,shape,batch", CMB, ids=ts.ids)
def test_cache_matches_reference_after_every_call(reference, runs, case,
                                                  shape, batch):
    """The ring, gathered from the ranks' blocks, after prefill and after
    each decode step within TOL of the reference's, ``pos`` exact: a key
    written to the wrong rank's slots, or a prompt longer than the ring
    kept wrongly, shows here."""
    ts.check_caches(reference, runs[case[0], shape, batch], case[0], shape,
                    batch)


@pytest.mark.parametrize("case,shape,batch", CMB, ids=ts.ids)
def test_greedy_tokens_match_reference(reference, runs, case, shape,
                                       batch):
    """Each decode step's greedy tokens (the argmax over the vocabulary
    lanes split over "model") equal the reference's."""
    ts.check_tokens(reference, runs[case[0], shape, batch], case[0], shape,
                    batch)


@pytest.mark.parametrize("case,shape,batch", CMB, ids=ts.ids)
def test_blocks_shaped_as_reference_shards(reference, runs, case, shape,
                                           batch):
    """Each rank's blocks of the logits, the next token and the cache are
    the reference's shards on the device at its mesh coordinates."""
    ts.check_block_shapes(reference, runs[case[0], shape, batch], case[0],
                          shape, batch)


@pytest.mark.parametrize("case,shape,batch", CMB, ids=ts.ids)
def test_decode_combines_over_the_slot_team(runs, case, shape, batch):
    """A decode step's softmax is combined (a ``pmax`` of the row maxima)
    over exactly the axes the ring's slots split over, and over none where
    the ring is whole on each rank."""
    ts.check_slot_team(runs[case[0], shape, batch], case[1], case[2],
                       shape, batch, case[3])


def test_mesh_serving_refuses_what_it_cannot_honour():
    """No silent fallback: a mesh without the global batch, a rank given
    other rows than its own, and a cache that is not the rank's blocks
    are refused on every rank."""
    pool = RankPool(4)
    try:
        res = pool.run(ts.td.tp_serve_refusals)
    finally:
        pool.close()
    for r in res:
        assert r == ["batch", "rows", "cache"], r
