"""The port's sharded serving steps (``make_prefill_step``,
``make_decode_step`` and ``prefill_chunk`` under a ``MeshPolicy`` on a
``ProcessMesh``: the sequence-sharded KV cache, its shard-local writes,
the decode kernel's range form merged over the shards) and A.7's
sampling against the JAX package's, on the CPU.

The reference runs in one subprocess with eight host devices, jitting
``make_prefill_step``, ``make_decode_step`` and ``M.prefill_chunk`` with
the shardings ``launch/dryrun.py``'s ``build_cell`` gives them (params by
``param_specs``, the batch by ``batch_specs``, tokens over the data axis,
the cache by ``cache_specs``, the position replicated).  The port runs
the same cases in eight gloo processes
(``tests/torch_sharded_serving_cases.py``), from the same weights (drawn
once and saved); both sides run once per module, at the same time.
Cases: mixtral-smoke and granite-smoke (vocabulary 250, padded to 252)
at ``shard_multiple`` 4, at B 8 on meshes (2, 4) and (4, 2) and at B 1 on
(2, 4), where the sequence spans all 8 ranks; 20-token prompts into a
64-slot cache, 3 decode steps, then a chunk of 8 tokens at per-row
offsets, some across a shard's edge.  With mixtral's window of 8 the
window spans two shards and the others hold no valid key.  One decode
step each of olmo, gemma3 (local and global layers), qwen1.5, deepseek-moe
and phi-3-vision (its prefill over patches and tokens), each with the
embed step over its prompts.

Tolerances, set beforehand: the f32 logits and every cache leaf at the
model tolerance 1e-4 (``tests/test_torch_model.py``), the next tokens
exactly.  After every step each cache leaf is placed by ``cache_specs``,
its local shard has the shape that placement gives, and the decode and
chunk steps keep its storage (written in place, never gathered or
copied).  The null policy is held bitwise to the port before this slice
(the commit ``PARENT``, read from git).  A.7: under the JAX package's
``jax.random.gumbel`` noise the port's tokens equal its own exactly; a
5-way categorical at temperature 0.7 over 20,000 draws passes a
chi-square test at p 0.001; temperature <= 0 is greedy.  The families the
serving steps do not run on a mesh yet raise.  Each subprocess carries a
timeout.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
torch.set_num_threads(1)

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as S
from repro_torch.models.config import SHAPES, cell_is_supported
from repro_torch.serving import steps as ST

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_sharded_serving_cases as C  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MODEL_TOL = 1e-4
PARENT = "7587721bb3b8792e03a402ae2019f8baabf6f6ea"
TIMEOUT = 300
CHI2_P001_4DOF = 18.467          # chi-square quantile, 4 dof, p = 0.001
DRAWS = 20_000

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, "src")
    sys.path.insert(0, "tests")
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_smoke_config
    from repro.launch.mesh import make_mesh
    from repro.models import model as M
    from repro.models import sharding as S
    from repro.serving.steps import (_sample, make_decode_step,
                                     make_embed_step, make_prefill_step)
    import torch_sharded_serving_cases as C

    out = sys.argv[1]
    res = {}

    def load(name, like):
        flat = np.load(f"{out}/params_{name}.npz")
        def build(t, pre):
            if isinstance(t, dict):
                return {k: build(v, f"{pre}{k}/") for k, v in t.items()}
            if isinstance(t, list):
                return [build(v, f"{pre}{i}/") for i, v in enumerate(t)]
            return jnp.asarray(flat[pre[:-1]], t.dtype)
        return build(like, "")

    def put(tree, mesh, specs):
        return jax.tree.map(
            lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), tree,
            specs, is_leaf=lambda x: not isinstance(x, (dict, list)))

    for name in sorted(C.CASES):
        arch, kw, shape, B, steps, chunk = C.CASES[name]
        cfg = get_smoke_config(arch).replace(shard_multiple=4, remat=False,
                                             **C.F32, **kw)
        mesh = make_mesh(tuple(shape), ("data", "model"))
        policy = S.MeshPolicy(mesh, cfg, B)
        pspecs = S.param_specs(cfg, mesh)
        psh = S.to_shardings(mesh, pspecs)
        params = put(load(name, jax.eval_shape(
            lambda: M.init_params(cfg, jax.random.PRNGKey(0)))), mesh, pspecs)
        tokens, patches, chunk_tokens, offsets = C.case_inputs(name)
        batch = {"tokens": jnp.asarray(tokens)}
        if patches is not None:
            batch["patches"] = jnp.asarray(patches)
        bsh = S.to_shardings(mesh, S.batch_specs(cfg, mesh, B, "prefill"))
        pre = jax.jit(make_prefill_step(cfg, C.CACHE, policy),
                      in_shardings=(psh, bsh))
        o = pre(params, batch)
        r = {"prefill_logits": o["logits"], "next_0": o["next_token"]}
        csh = S.to_shardings(mesh, S.cache_specs(cfg, mesh, B))
        tsh = NamedSharding(mesh, P(S._dp(mesh, B), None))
        dec = jax.jit(make_decode_step(cfg, policy),
                      in_shardings=(psh, tsh, csh, NamedSharding(mesh, P())))
        cache, pos, tok = o["cache"], int(o["pos"]), o["next_token"]
        for i in range(steps):
            o = dec(params, tok, cache, jnp.int32(pos + i))
            cache, tok = o["cache"], o["next_token"]
            r[f"decode_logits_{i}"] = o["logits"]
            r[f"next_{i + 1}"] = tok
        r.update({f"cache/{k}": v for k, v in C.flatten(cache).items()})
        if chunk:
            ext = jax.jit(lambda p, t, c, off: M.prefill_chunk(
                cfg, p, t, c, off, policy),
                in_shardings=(psh, tsh, csh, NamedSharding(mesh, P())))
            logits, cache = ext(params, jnp.asarray(chunk_tokens), cache,
                                jnp.asarray(offsets))
            r["chunk_logits"] = logits
            r.update({f"chunk_cache/{k}": v
                      for k, v in C.flatten(cache).items()})
        else:
            r["embed"] = jax.jit(make_embed_step(cfg, policy),
                                 in_shardings=(psh, bsh))(params, batch)
        res.update({f"{name}/{k}": np.asarray(v) for k, v in r.items()})

    # A.7: the reference's draws and the noise they came from
    cfg = get_smoke_config("granite-8b").replace(vocab_size=250,
                                                 shard_multiple=4)
    rng = np.random.default_rng(7)
    logits = jnp.asarray(rng.standard_normal((6, 1, cfg.padded_vocab)),
                         jnp.float32)
    res["a7/logits"] = np.asarray(logits)
    for i, t in enumerate((0.7, 1.3, 0.0, -1.0)):
        key = jax.random.PRNGKey(i)
        res[f"a7/tokens_{i}"] = np.asarray(_sample(cfg, logits, key, t))
        res[f"a7/noise_{i}"] = np.asarray(
            jax.random.gumbel(key, logits.shape, jnp.float32))
    np.savez(out + "/reference.npz", **res)
    print("ok")
""")

# the null policy before this slice: its model entry points and the
# decode kernel's plain version, bitwise
NULL_RUN = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.params import init_params
    from repro_torch.serving.steps import make_embed_step

    out = {}
    for arch in ("granite-8b", "mixtral-8x7b", "gemma3-12b"):
        for dt in ("float32", "bfloat16"):
            cfg = get_smoke_config(arch).replace(param_dtype=dt,
                                                 compute_dtype=dt)
            params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            g = torch.Generator().manual_seed(1)
            tokens = torch.randint(0, cfg.vocab_size, (4, 12), generator=g)
            key = f"{arch}_{dt}_"
            logits, cache, pos = M.prefill(cfg, params, {"tokens": tokens},
                                           32)
            out[key + "prefill"] = logits.float().numpy()
            for i in range(3):
                logits, cache = M.decode_step(cfg, params, logits.argmax(-1),
                                              cache, pos + i)
                out[key + f"decode_{i}"] = logits.float().numpy()
            logits, cache = M.prefill_chunk(
                cfg, params, tokens[:, :6], cache,
                torch.tensor([3, 15, 9, 20]))
            out[key + "chunk"] = logits.float().numpy()
            out[key + "cache"] = cache[0]["b0"]["attn"]["k"].float().numpy()
            out[key + "embed"] = make_embed_step(cfg)(
                params, {"tokens": tokens}).numpy()
    g = torch.Generator().manual_seed(2)
    q = torch.randn((3, 1, 8, 16), generator=g)
    k, v = (torch.randn((3, 40, 2, 16), generator=g) for _ in range(2))
    for w in (0, 8):
        o = decode_attention(q, k, v, torch.tensor([39, 5, 20]), window=w)
        out[f"decode_attention_{w}"] = o.numpy()
        o = L.chunked_attention(q.expand(3, 4, 8, 16).contiguous(), k, v,
                                causal=True, window=w,
                                q_offset=torch.tensor([30, 2, 17]),
                                block_k=16)
        out[f"chunked_{w}"] = o.numpy()
    np.savez(sys.argv[1], **out)
""")


def _env(*paths):
    return dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join(str(p) for p in paths))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides, started together: (reference arrays, port arrays, the
    port's cache records)."""
    d = tmp_path_factory.mktemp("sharded_serving")
    C.write_inputs(d)
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd, env in (
                 ([sys.executable, "-c", REFERENCE, str(d)],
                  _env(ROOT / "src")),
                 ([sys.executable, "-c", "import sys, torch_sharded_serving_"
                   "cases as C; C.main(sys.argv[1])", str(d)],
                  _env(ROOT / "src", ROOT / "tests")))]
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
    return (dict(np.load(d / "reference.npz")), dict(np.load(d / "port.npz")),
            json.loads((d / "port.json").read_text()))


# --------------------------------------------------------------------------
# the steps against the reference's jitted steps
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(C.CASES))
def test_sharded_steps_match_reference(runs, case):
    ref, port, _ = runs
    keys = sorted(k for k in ref if k.startswith(case + "/"))
    assert keys and keys == sorted(k for k in port if k.startswith(case + "/"))
    steps = C.CASES[case][4]
    assert sum("decode_logits" in k for k in keys) == steps
    for k in keys:
        if "next_" in k:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(port[k], ref[k], atol=MODEL_TOL,
                                       rtol=MODEL_TOL, err_msg=k)


@pytest.mark.parametrize("case", sorted(C.CASES))
def test_cache_stays_sharded_and_in_place(runs, case):
    """After every step each cache leaf is placed by ``cache_specs``, its
    local shard is the full shape cut by that placement, and the decode
    and chunk steps wrote it where it lay."""
    *_, records = runs
    arch, kw, shape, B, steps, chunk = C.CASES[case]
    cfg = C.case_config(case)
    mesh = make_mesh(shape, ("data", "model"), devices=["cpu"] * 8)
    specs = S.flat_specs(S.cache_specs(cfg, mesh, B))
    full = C.flatten(M.init_cache(cfg, B, C.CACHE, "meta"))
    want = {}
    for k, spec in specs.items():
        places = S.placements(mesh, spec, full[k].ndim)
        local = list(full[k].shape)
        for mdim, p in enumerate(places):
            if isinstance(p, S.Shard):
                local[p.dim] //= shape[mdim]
        want[k] = ([f"Shard({p.dim})" if isinstance(p, S.Shard)
                    else "Replicate" for p in places], local)
    names = ["prefill", *(f"decode_{i}" for i in range(steps))]
    assert set(records[case]) == set(names + (["chunk"] if chunk else []))
    for step, rec in records[case].items():
        assert set(rec) == set(want), step
        for k, r in rec.items():
            assert (r["placements"], r["local"]) == want[k], (step, k, r)
            assert r["in_place"] == (step != "prefill"), (step, k)
    # the sequence over "model", and over "data" too where the batch
    # does not divide it (B 1)
    places = want["0/b0/attn/k"][0]
    assert places == (["Shard(2)", "Shard(2)"] if B % shape[0]
                      else ["Shard(1)", "Shard(2)"])


# --------------------------------------------------------------------------
# A.7: sampling
# --------------------------------------------------------------------------
@pytest.mark.parametrize("i,temperature", enumerate((0.7, 1.3, 0.0, -1.0)))
def test_sample_matches_reference_under_its_noise(runs, monkeypatch, i,
                                                  temperature):
    ref, *_ = runs
    cfg = get_smoke_config("granite-8b").replace(vocab_size=250,
                                                 shard_multiple=4)
    noise = torch.from_numpy(ref[f"a7/noise_{i}"])
    monkeypatch.setattr(ST, "gumbel_noise", lambda shape, g, device: noise)
    logits = torch.from_numpy(ref["a7/logits"])
    got = ST._sample(cfg, logits, torch.Generator().manual_seed(0),
                     temperature)
    np.testing.assert_array_equal(got.numpy(), ref[f"a7/tokens_{i}"])
    assert (got < cfg.vocab_size).all()


def test_sample_draws_the_categorical():
    """20,000 draws of a 5-way categorical at temperature 0.7: the counts
    against softmax(logits / 0.7) pass a chi-square test at p 0.001."""
    cfg = get_smoke_config("granite-8b").replace(vocab_size=5)
    base = torch.tensor([0.3, -0.5, 1.0, 0.1, -1.2])
    logits = base.expand(DRAWS, 1, 5).contiguous()
    tokens = ST._sample(cfg, logits, torch.Generator().manual_seed(3), 0.7)
    counts = torch.bincount(tokens.flatten().long(), minlength=5).double()
    expected = torch.softmax(base.double() / 0.7, 0) * DRAWS
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < CHI2_P001_4DOF, (chi2, counts.tolist())


@pytest.mark.parametrize("temperature", [0.0, -0.5])
def test_sample_at_temperature_zero_is_greedy(temperature):
    cfg = get_smoke_config("granite-8b").replace(vocab_size=250,
                                                 shard_multiple=4)
    logits = torch.randn((8, 1, cfg.padded_vocab),
                         generator=torch.Generator().manual_seed(4))
    logits[:, :, cfg.vocab_size:] = 50.0          # the padded rows
    greedy = ST._sample(cfg, logits)
    assert (greedy < cfg.vocab_size).all()
    got = ST._sample(cfg, logits, torch.Generator().manual_seed(5),
                     temperature)
    assert torch.equal(got, greedy)


# --------------------------------------------------------------------------
# what does not run on a mesh yet, and the shape cells
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kw", [
    ("falcon-mamba-7b", {}), ("recurrentgemma-9b", {}), ("whisper-base", {}),
    ("qwen1.5-32b", {"kv_quant": "int8"})])
def test_unported_families_refuse_a_mesh(arch, kw):
    cfg = get_smoke_config(arch).replace(**kw)
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        M.init_cache(cfg, 8, 64, "cpu", mesh=mesh)
    policy = S.MeshPolicy(mesh, cfg, 8)
    with pytest.raises(NotImplementedError, match="on a mesh"):
        M.decode_step(cfg, None, torch.zeros((8, 1), dtype=torch.int64),
                      None, 3, policy)
    with pytest.raises(NotImplementedError, match="on a mesh"):
        ST.make_prefill_step(cfg, 64, policy)(
            None, {"tokens": torch.zeros((8, 4), dtype=torch.int64)})


def test_shape_cells_match_reference():
    from repro.models import config as JC
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in JC.SHAPES.items()}
    assert SHAPES["decode_32k"].seq_len == 32_768
    for arch in ("mixtral-8x7b", "olmo-1b", "falcon-mamba-7b"):
        for cell in SHAPES:
            assert cell_is_supported(arch, cell) == JC.cell_is_supported(
                arch, cell)


# --------------------------------------------------------------------------
# the null policy, bitwise the port before this slice
# --------------------------------------------------------------------------
def test_null_policy_is_bitwise_the_parent(tmp_path):
    old = tmp_path / "old"
    old.mkdir()
    arch = subprocess.run(["git", "-C", str(ROOT), "archive", PARENT,
                           "src/repro_torch"], capture_output=True)
    if arch.returncode != 0:
        pytest.skip(f"commit {PARENT} is not in this checkout's history")
    subprocess.run(["tar", "-x", "-C", str(old)], input=arch.stdout,
                   check=True)
    outs = {}
    for name, src in (("old", old / "src"), ("new", ROOT / "src")):
        path = tmp_path / f"{name}.npz"
        run = subprocess.run([sys.executable, "-c", NULL_RUN, str(path)],
                             cwd=ROOT, env=_env(src), capture_output=True,
                             text=True, timeout=TIMEOUT)
        assert run.returncode == 0, run.stderr[-4000:]
        outs[name] = dict(np.load(path))
    assert set(outs["old"]) == set(outs["new"])
    for k, v in outs["old"].items():
        np.testing.assert_array_equal(outs["new"][k], v, err_msg=k)
