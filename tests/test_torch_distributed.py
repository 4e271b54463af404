"""The port's mesh-sharded corpus scan (``repro_torch.retrieval.
distributed``, ``VectorIndex``'s mesh route, ``repro_torch.launch.mesh``)
against the JAX package's, on the CPU.

The reference's ``make_sharded_topk`` and ``VectorIndex(mesh=)`` need
eight devices: they run in one subprocess with
``--xla_force_host_platform_device_count=8`` (as
``tests/test_distributed.py`` runs them), on the inputs this module draws
with numpy from seed 0 and hands over in a file.  The port runs the same
cases on meshes of eight entries of the CPU device.  Meshes (8,)
("data",) and (2, 4) ("data", "model"), the latter also with the corpus
over "data" alone; cases: the reference's own (4096 x 32, 5 queries,
k 10), a ragged N of 4,001, N 5 below 8 shards, and N 40 where k 10 is
above the 5 rows a shard.  Scores within 1e-5 (the port's index holds
unit rows and does not normalise them again, the reference normalises
inside the call), ids exact.

The reference's bound scan refuses a corpus whose row count the shard
count does not divide (its ``in_shardings`` put the unpadded corpus
over the mesh; ROADMAP C.18), and so does its ``VectorIndex(mesh=)``:
for N 4,001 and 5 the subprocess runs the bound function's own body
(``__wrapped__``, which pads as the sharded scan intends), the port is
held to that, and the refusal is asserted.

A corpus whose rows repeat across shards ties by id in the port, as its
``cosine_topk`` orders them (score desc, id asc); the reference's final
``lax.top_k`` over the gathered candidates is not held to an order
among ties, so its ids are recorded beside the port's (as a property of
the test) and held only to the same tied rows.
"""

import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.engine as TE
import repro_torch.retrieval as TR
from repro_torch.core import MockProvider, SemanticContext
from repro_torch.kernels.topk_sim import ops as topk_ops
from repro_torch.launch.mesh import Mesh, current_mesh, make_mesh
from repro_torch.retrieval import distributed as D

ROOT = Path(__file__).resolve().parents[1]
SCORE_TOL = 1e-5
CPU8 = ["cpu"] * 8
# name -> (N, D, Q, k); "tied" repeats 64 distinct rows 8 times
CASES = {"reference": (4096, 32, 5, 10), "ragged": (4001, 32, 5, 10),
         "tiny": (5, 32, 5, 10), "k_over_rows": (40, 32, 5, 10),
         "tied": (512, 32, 5, 20)}
# name -> (shape, axes, corpus_axes)
MESHES = {"8": ((8,), ("data",), None),
          "2x4": ((2, 4), ("data", "model"), None),
          "2x4_data": ((2, 4), ("data", "model"), ("data",))}

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, "src")
    import numpy as np
    import jax.numpy as jnp
    from repro.launch.mesh import make_mesh
    from repro.retrieval.distributed import make_sharded_topk
    from repro.retrieval.vector import VectorIndex

    cases, meshes, src, dst = json.loads(sys.argv[1])
    data = np.load(src)
    out = {}
    for mname, (shape, axes, corpus_axes) in meshes.items():
        mesh = make_mesh(shape, axes)
        for cname, (n, d, q, k) in cases.items():
            corpus, queries = data[cname + "_c"], data[cname + "_q"]
            fn = make_sharded_topk(mesh, k, corpus_axes=corpus_axes)
            args = (jnp.asarray(corpus), jnp.asarray(queries))
            # the bound scan's in_shardings refuse an N that the shard
            # count does not divide; its body pads and runs it
            try:
                s, i = fn(*args)
                refused = False
            except ValueError:
                s, i = fn.__wrapped__(*args)
                refused = True
            out[f"fn_{mname}_{cname}_s"] = np.asarray(s)
            out[f"fn_{mname}_{cname}_i"] = np.asarray(i)
            out[f"fn_{mname}_{cname}_refused"] = np.asarray(refused)
            if corpus_axes is None:
                try:
                    s, i = VectorIndex(corpus, mesh=mesh).topk(queries, k)
                    out[f"index_{mname}_{cname}_s"] = s
                    out[f"index_{mname}_{cname}_i"] = i
                except ValueError:
                    out[f"index_{mname}_{cname}_refused"] = np.asarray(True)
    np.savez(dst, **out)
    print(json.dumps({"results": len(out)}))
""")


def _draw():
    """Each case's (corpus, queries), drawn in CASES order from seed 0."""
    rng = np.random.default_rng(0)
    data = {}
    for name, (n, d, q, _) in CASES.items():
        if name == "tied":
            distinct = rng.standard_normal((64, d)).astype(np.float32)
            corpus = np.tile(distinct, (n // 64, 1))
        else:
            corpus = rng.standard_normal((n, d)).astype(np.float32)
        data[name] = (corpus, rng.standard_normal((q, d)).astype(np.float32))
    return data


@pytest.fixture(scope="module")
def inputs():
    return _draw()


@pytest.fixture(scope="module")
def reference(inputs, tmp_path_factory):
    """The JAX package's results, by key (module docstring)."""
    tmp = tmp_path_factory.mktemp("sharded_reference")
    src, dst = tmp / "inputs.npz", tmp / "out.npz"
    np.savez(src, **{f"{name}_{part}": arr for name, (c, q) in inputs.items()
                     for part, arr in (("c", c), ("q", q))})
    arg = json.dumps([CASES, MESHES, str(src), str(dst)])
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", REFERENCE, arg], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(dst) as f:
        return dict(f)


def _unit(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-9)


def _mesh(name):
    shape, axes, corpus_axes = MESHES[name]
    return make_mesh(shape, axes, devices=CPU8), corpus_axes


def _port(mesh, corpus_axes, corpus, queries, k):
    shards = D.shard_corpus(mesh, _unit(corpus), corpus_axes)
    s, i = D.make_sharded_topk(mesh, k, corpus_axes=corpus_axes)(
        shards, torch.from_numpy(queries))
    return s.numpy(), i.numpy()


def _held(s, i, ref_s, ref_i):
    np.testing.assert_array_equal(i, ref_i)
    np.testing.assert_allclose(s, ref_s, atol=SCORE_TOL, rtol=0)


UNTIED = [c for c in CASES if c != "tied"]


@pytest.mark.parametrize("case", UNTIED)
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_topk_matches_jax(reference, inputs, mesh_name, case):
    corpus, queries = inputs[case]
    k = CASES[case][3]
    mesh, corpus_axes = _mesh(mesh_name)
    s, i = _port(mesh, corpus_axes, corpus, queries, k)
    assert s.shape == i.shape == (len(queries), min(k, len(corpus)))
    assert s.dtype == np.float32 and i.dtype == np.int32
    _held(s, i, reference[f"fn_{mesh_name}_{case}_s"],
          reference[f"fn_{mesh_name}_{case}_i"])
    n_shards = 2 if MESHES[mesh_name][2] else 8
    assert bool(reference[f"fn_{mesh_name}_{case}_refused"]) == bool(
        len(corpus) % n_shards)
    # and the port's plain formulation, the oracle of the sharded route
    o_s, o_i = D.sharded_topk(torch.from_numpy(corpus),
                              torch.from_numpy(queries), k)
    _held(s, i, o_s.numpy(), o_i.numpy())


@pytest.mark.parametrize("case", UNTIED)
@pytest.mark.parametrize("mesh_name", ["8", "2x4"])
def test_vector_index_mesh_route_matches_jax(reference, inputs, mesh_name,
                                             case):
    corpus, queries = inputs[case]
    k = CASES[case][3]
    mesh, _ = _mesh(mesh_name)
    s, i = TR.VectorIndex(corpus, mesh=mesh).topk(queries, k)
    if len(corpus) % 8:                  # the reference refuses (C.18)
        assert f"index_{mesh_name}_{case}_refused" in reference
        _held(s, i, reference[f"fn_{mesh_name}_{case}_s"],
              reference[f"fn_{mesh_name}_{case}_i"])
    else:
        _held(s, i, reference[f"index_{mesh_name}_{case}_s"],
              reference[f"index_{mesh_name}_{case}_i"])
    # the single-device route of the same index agrees
    s1, i1 = TR.VectorIndex(corpus, device="cpu").topk(queries, k)
    _held(s, i, s1, i1)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_tied_corpus_orders_by_id(reference, inputs, mesh_name,
                                  record_property):
    """Rows repeat across shards: the port returns (score desc, id asc),
    as its ``cosine_topk``; the reference's ids are recorded and hold the
    same rows."""
    corpus, queries = inputs["tied"]
    k = CASES["tied"][3]
    mesh, corpus_axes = _mesh(mesh_name)
    s, i = _port(mesh, corpus_axes, corpus, queries, k)
    c_s, c_i = TR.cosine_topk(torch.from_numpy(_unit(corpus)),
                              torch.from_numpy(queries), k)
    _held(s, i, c_s.numpy(), c_i.numpy())
    # each tie run is one distinct row at ascending ids, 64 apart
    assert (np.diff(i, axis=1)[:, :7] == 64).all()
    jax_s = reference[f"fn_{mesh_name}_tied_s"]
    jax_i = reference[f"fn_{mesh_name}_tied_i"]
    record_property("jax_ids", jax_i.tolist())
    record_property("jax_ids_equal_port", bool(np.array_equal(jax_i, i)))
    np.testing.assert_allclose(jax_s, s, atol=SCORE_TOL, rtol=0)
    np.testing.assert_array_equal(jax_i % 64, i % 64)


def test_shards_follow_the_reference_layout():
    """Shard sizes sum to N in the reference's order (``ceil(N /
    shards)`` each, the last shorter, trailing shards empty), each on its
    device; under ``mesh=`` the index holds no tensor of the whole corpus
    and the gathered candidates are (Q, shards * kl)."""
    assert D.shard_bounds(4001, 8)[-2:] == [(3006, 3507), (3507, 4001)]
    assert [b - a for a, b in D.shard_bounds(5, 8)] == [1] * 5 + [0] * 3
    assert [b - a for a, b in D.shard_bounds(9, 8)] == [2] * 4 + [1, 0, 0,
                                                                  0]
    rng = np.random.default_rng(3)
    vs = rng.standard_normal((4001, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    mesh = make_mesh((8,), ("data",), devices=CPU8)
    index = TR.VectorIndex(vs, mesh=mesh)
    shards = index._placed(mesh)
    assert [s.shape[0] for s in shards] == [501] * 7 + [494]
    assert sum(s.shape[0] for s in shards) == len(index) == 4001
    assert index.vectors is None
    assert not [name for name, v in vars(index).items()
                if torch.is_tensor(v) and v.shape[0] == len(vs)]
    # shards are placed once: a second topk reuses them
    assert index._placed(mesh) is shards
    with mock.patch.object(D, "merge_candidates",
                           wraps=D.merge_candidates) as merge, \
            mock.patch.object(D, "topk_normalised",
                              wraps=D.topk_normalised) as local:
        index.topk(q, 10)
    (cand_s, cand_i, k), _ = merge.call_args
    assert cand_s.shape == cand_i.shape == (3, 8 * 10) and k == 10
    assert local.call_count == 8
    # each shard scanned as it lies, not a copy of it
    assert [c.args[0].data_ptr() for c in local.call_args_list] == [
        s.data_ptr() for s in shards]


def test_shards_over_part_of_the_mesh():
    """The corpus over "data" of a (2, 4) mesh: 2 shards, on the devices
    at model index 0; over ("model", "data"): the first axis slowest."""
    devs = [torch.device("cpu", i) for i in range(8)]
    mesh = make_mesh((2, 4), ("data", "model"), devices=devs)
    assert D.shard_devices(mesh, ("data",)) == [devs[0], devs[4]]
    assert D.shard_devices(mesh) == devs
    assert D.shard_devices(mesh, ("model", "data")) == [
        devs[0], devs[4], devs[1], devs[5], devs[2], devs[6], devs[3],
        devs[7]]
    assert D._flat_axes(mesh, "data") == ("data",)
    assert D._flat_axes(mesh, (("data", "model"),)) == ("data", "model")


def test_sharded_scan_validates_its_shards():
    mesh = make_mesh((8,), ("data",), devices=CPU8)
    fn = D.make_sharded_topk(mesh, 3)
    vs = torch.from_numpy(_unit(np.ones((16, 4), np.float32)))
    with pytest.raises(ValueError, match="2 shards for a mesh of 8"):
        fn([vs[:8], vs[8:]], vs[:1])
    with pytest.raises(ValueError, match="layout"):
        fn([vs[:2]] + [vs[:1]] * 7, vs[:1])      # 9 rows: 2,2,2,2,1,0,0,0
    # an empty corpus or query set gives empty results
    empty = D.shard_corpus(mesh, np.zeros((0, 4), np.float32))
    s, i = fn(empty, vs[:2])
    assert s.shape == i.shape == (2, 0)


def test_active_mesh_is_the_innermost_of_this_thread():
    assert TR.active_mesh() is None and current_mesh() is None
    outer = make_mesh((8,), ("data",), devices=CPU8)
    inner = make_mesh((2, 4), ("data", "model"), devices=CPU8)
    seen = []
    with outer:
        assert TR.active_mesh() is outer
        with inner:
            assert TR.active_mesh() is inner
            worker = threading.Thread(
                target=lambda: seen.append(TR.active_mesh()))
            worker.start()
            worker.join()
        assert TR.active_mesh() is outer
    assert TR.active_mesh() is None and seen == [None]
    # a single-device mesh is reported as None, as in the reference
    with make_mesh((1,), ("data",), devices=["cpu"]):
        assert TR.active_mesh() is None and current_mesh() is not None


def test_mesh_has_the_reference_attributes():
    mesh = make_mesh((2, 4), ("data", "model"), devices=CPU8)
    assert mesh.shape == {"data": 2, "model": 4} and mesh.size == 8
    assert mesh.devices.shape == (2, 4) and not mesh.empty
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert Mesh([["cpu", "cpu"]], ("a", "b")).shape == {"a": 1, "b": 2}
    with pytest.raises(ValueError):
        Mesh(["cpu", "cpu"], ("a", "b"))
    with pytest.raises(ValueError):
        make_mesh((2, 4), ("data",), devices=CPU8)
    with pytest.raises(RuntimeError, match="needs 8 devices, 4 given"):
        make_mesh((8,), ("data",), devices=["cpu"] * 4)


def test_make_mesh_defaults_to_cuda_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh((2,), ("data",))
    assert list(mesh.devices) == [torch.device("cuda", 0),
                                  torch.device("cuda", 1)]
    with pytest.raises(RuntimeError, match="needs 4 devices, 2 given"):
        make_mesh((4,), ("data",))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="needs 1 devices, 0 given"):
        make_mesh((1,), ("data",))


def test_index_without_mesh_routes_by_the_enclosing_mesh():
    """Shards placed from the host copy on first use under ``with mesh:``,
    once a mesh; without it the single-device route."""
    rng = np.random.default_rng(5)
    vs = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    index = TR.VectorIndex(vs, device="cpu")
    alone = index.topk(q, 12)
    mesh = make_mesh((8,), ("data",), devices=CPU8)
    with mock.patch.object(topk_ops, "block_max_scores",
                           wraps=topk_ops.block_max_scores) as bm:
        with mesh:
            first = index.topk(q, 12)
            again = index.topk(q, 12)
        assert bm.call_count == 16          # one a shard a call
        after = index.topk(q, 12)
        assert bm.call_count == 17
    assert list(index._shards) == [id(mesh)]
    for got in (first, again, after):
        _held(*got, *alone)


def test_extended_and_build_keep_the_mesh():
    rng = np.random.default_rng(6)
    vs = rng.standard_normal((100, 16)).astype(np.float32)
    q = rng.standard_normal((2, 16)).astype(np.float32)
    mesh = make_mesh((8,), ("data",), devices=CPU8)
    grown = TR.VectorIndex(vs[:60], mesh=mesh).extended(vs[60:])
    assert grown.mesh is mesh and grown.vectors is None
    _held(*grown.topk(q, 9), *TR.VectorIndex(vs, device="cpu").topk(q, 9))
    ctx = SemanticContext(provider=MockProvider(), device="cpu")
    emb = {"model": "e", "embedding_dim": 16, "context_window": 4096}
    texts = [f"passage {i} on joins" for i in range(40)]
    built = TR.VectorIndex.build(ctx, emb, texts, mesh=mesh)
    plain = TR.VectorIndex.build(ctx, emb, texts)
    assert built.mesh is mesh and len(built) == 40
    _held(*built.topk(q, 5), *plain.topk(q, 5))


def test_hybrid_plan_under_mesh_equals_the_plan_without():
    """The counterpart of ``tests/test_retrieval_ops.py::
    test_vector_index_sharded_path_matches_oracle`` at the plan level: a
    ``hybrid_topk`` + ``llm_rerank`` plan collected under ``with mesh:``
    returns the same table as without it, and its scan ran through the
    mesh."""
    emb = {"model": "e", "embedding_dim": 16, "context_window": 4096}
    chat = {"model": "m", "context_window": 8192, "max_output_tokens": 16}
    topics = ("joins", "indexes", "vectors")
    corpus = TE.Table({"content": [
        f"doc {i} about {topics[i % 3]} with a body of searchable text"
        for i in range(48)]})
    queries = TE.Table({"q": ["join algorithms", "vector search"]})

    def collect():
        ctx = SemanticContext(provider=MockProvider(), device="cpu")
        return (TE.Pipeline(ctx, queries, "queries")
                .hybrid_topk("score", emb, "q", corpus, k=6,
                             doc_col="content", candidate_k=12)
                .llm_rerank(chat, {"prompt": "most relevant"},
                            ["content"], by="q")
                .collect())

    plain = collect()
    mesh = make_mesh((8,), ("data",), devices=CPU8)
    with mock.patch.object(D, "topk_normalised",
                           wraps=D.topk_normalised) as local:
        with mesh:
            meshed = collect()
    assert local.call_count == 8
    assert meshed.columns == plain.columns
