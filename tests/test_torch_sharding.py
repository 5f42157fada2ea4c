"""Multi-GPU serving on the CPU: `bark_tpu_torch.parallel` on gloo ranks,
held against `bark_tpu.parallel.sharding` on conftest's 8 virtual
devices (the counterparts of tests/test_sharding.py, test_dp_serving.py
and test_sharded_serving.py).

The port's ranks run in two spawns (`parallel.launch.spawn`, 2 and 4
ranks, one torch thread each), started together in the background while
this process computes bark_tpu's references; the rank functions live in
`bark_tpu_torch.parallel.ranks` (a spawned rank imports the module that
defines its function, and this one imports jax), and bark_tpu's lane
noise reaches them as .npz files. The batches are held against
bark_tpu's UNSHARDED `generate_audio_batch` on the same weights and keys
(tests/test_dp_serving.py and test_sharded_serving.py hold bark_tpu's dp
and tp runs equal to its unsharded one; compiling the sharded programs
too would take this module past its time): each lane's semantic, coarse
and fine tokens equal, its audio within DP_ATOL (dp, as bark_tpu holds
its dp lanes) or TP_ATOL (tp, as bark_tpu holds its GSPMD run), and every
rank returns the same lanes. Also: the specs entry by entry, the shards'
shapes and the fused QKV's head slices column by column, the step
factories at (dp 2, tp 2) within 2e-5 of bark_tpu's on its mesh, the
port's dp batch bit-equal to its own unsharded batch under the default
noise source, a world of 1 in this process, a failing rank, and the dry
run in a subprocess.
"""

import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu
import bark_tpu_torch
import torch_jax_reference as ref
from bark_tpu.io import ggml, loader as jloader
from bark_tpu.models import gpt as jgpt
from bark_tpu.parallel import sharding as jsharding
from bark_tpu_torch.models.config import GPTConfig
from bark_tpu_torch.parallel import launch, ranks, sharding, tp
from bark_tpu_torch.pipeline import coarse as tcoarse
from bark_tpu_torch.pipeline import fine as tfine

from test_torch_e2e import gumbel_from_key, one_torch_thread  # noqa: F401
from tiny_model import build_tiny_model, tiny_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DP_ATOL, TP_ATOL = 1e-5, 1e-4
P4 = ["hello world", "the a world", "world", "a the hello"]
P3 = ["hello world", "the a hello", "world world the"]
STAGES = ("semantic", "coarse", "fine")
# the step factories' model (tests/test_sharding.py's)
CFG = dict(n_layer=2, n_head=4, n_embd=64, block_size=32, n_in_vocab=96,
           n_out_vocab=64, bias=True)
INT8 = dict(temp=0.0, fine_temp=0.0, kv_cache_dtype="int8")

# (name, world, mode, weights, params, seed, prompts, replayed noise):
# every batch the ranks serve, and the bark_tpu run each is held to
BATCHES = [
    ("dp2-f32", 2, "dp", "f32", {}, 7, P4, True),
    ("dp2-q8_0", 2, "dp", "q8_0", {}, 13, P4, True),
    ("dp2-int8-temp0", 2, "dp", "f32", INT8, 0, P4, False),
    ("dp4-B3", 4, "dp", "f32", {}, 11, P3, True),
    ("tp-f32", 4, "tp", "f32", {}, 7, P4, True),
    ("tp-q8_0", 4, "tp", "q8_0", {}, 13, P4, True),
    ("tp-int8-temp0", 4, "tp", "f32", INT8, 0, P4, False),
]
DEFAULT_NOISE = 5  # the seed of the default-noise batches


def _port_params(**kw) -> dict:
    """tiny_params as the port's BarkContextParams fields (a spawned rank
    must not unpickle bark_tpu's class)."""
    p = tiny_params(**kw)
    return {f: getattr(p, f) for f in p.__dataclass_fields__}


def _record_noise(path: str, seed: int, B: int) -> str:
    """bark_tpu's lane noise for a B-prompt batch (keys[b], keys[Bp + b],
    keys[2Bp + b] of the batch padded to Bp), each stage's rows for the
    most windows and fine blocks the tiny model can take."""
    p = tiny_params()
    Bp = 1 << (B - 1).bit_length()
    key, keys = jax.random.PRNGKey(seed), []
    for _ in range(3 * Bp):
        key, sub = jax.random.split(key)
        keys.append(sub)
    steps = tcoarse.max_coarse_steps(p.n_steps_text_encoder, p)
    windows = -(-steps // p.sliding_window_size)
    loops = tfine.fine_schedule(steps // p.n_coarse_codebooks, 64)[1]
    shapes = dict(
        semantic=(p.n_steps_text_encoder, 16),
        coarse=(windows, p.sliding_window_size, p.codebook_size),
        fine=(loops, p.n_fine_codebooks - p.n_coarse_codebooks, 64,
              p.codebook_size))
    arrays = {}
    for i, stage in enumerate(STAGES):
        for b in range(B):
            arrays[f"{stage}/{b}"] = gumbel_from_key(
                stage, keys[i * Bp + b], shapes[stage]).numpy()
    np.savez(path, **arrays)
    return path


def _mesh_arrays(path: str):
    """The step factories' weights (bark_tpu's init_params, non-zero
    biases) and inputs, as numpy."""
    cfg = jgpt.GPTConfig(**CFG)
    params = jax.tree.map(np.asarray,
                          jgpt.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.RandomState(1)
    for k in ("qkv_b", "proj_b", "fc_b", "out_b"):
        v = params["blocks"][k]
        params["blocks"][k] = (rng.randn(*v.shape) * 0.02).astype(np.float32)
    toks = np.random.RandomState(0).randint(0, CFG["n_in_vocab"], (2, 8))
    inputs = dict(
        tokens=np.arange(4, dtype=np.int32) + 3, n_past=np.int32(5),
        x_emb=params["wte"][0][toks], n_valid=np.array([8, 5], np.int32),
        tokens2=np.array([1, 2], np.int32))
    flat = {k: v for k, v in params.items() if k != "blocks"}
    flat.update({f"blocks/{k}": v for k, v in params["blocks"].items()})
    np.savez(path, **flat, **inputs)
    return params, inputs


def _jax_factories(params, inputs):
    """bark_tpu's step factories at (dp 2, tp 2) on the first 4 of the 8
    virtual devices: decode on fresh caches, prefill, decode after it."""
    cfg = jgpt.GPTConfig(**CFG)
    mesh = jsharding.make_mesh(4, dp=2)
    sp = jsharding.shard_gpt_params(mesh, cfg, params)
    step = jsharding.make_batched_decode_step(cfg, mesh)
    kc, vc = jgpt.init_kv_cache(cfg, batch=4)
    decode, _, _ = step(sp, jnp.asarray(inputs["tokens"]), kc, vc,
                        jnp.int32(inputs["n_past"]))
    kc, vc = jgpt.init_kv_cache(cfg, batch=2)
    prefill = jsharding.make_batched_prefill(cfg, mesh)
    pre, kc, vc = prefill(sp, jnp.asarray(inputs["x_emb"]), kc, vc,
                          jnp.asarray(inputs["n_valid"]))
    decode2, _, _ = step(sp, jnp.asarray(inputs["tokens2"]), kc, vc,
                         jnp.int32(8))
    shapes = {k: v.addressable_shards[0].data.shape for k, v in sp.items()
              if k != "blocks"}
    shapes.update({f"blocks/{k}": v.addressable_shards[0].data.shape
                   for k, v in sp["blocks"].items()})
    return dict(decode=np.asarray(decode), prefill=np.asarray(pre),
                decode2=np.asarray(decode2), shapes=shapes)


def _jax_qpack_shapes(path: str) -> dict:
    mesh = jsharding.make_mesh(4, dp=2)
    _, qp = jloader.gpt_qparams_from_section(ggml.read_model_file(path).coarse)
    sq = jsharding.shard_qpack_params(mesh, qp)
    flat = dict(sq["blocks"], **{k: v for k, v in sq.items()
                                 if k != "blocks"})
    return {k: v.addressable_shards[0].data.shape for k, v in flat.items()}


def _jax_batch(name, weights, params, seed, prompts):
    """bark_tpu's unsharded batch: (audio, lanes' tokens)."""
    from test_torch_quant_batched_e2e import bark_tpu_batch_lanes

    if params:  # the int8 cache at temp 0: a context of its own
        jctx = bark_tpu.bark_load_model(ref.weights(weights),
                                        tiny_params(**params), seed=seed)
        return bark_tpu_batch_lanes(jctx, prompts)
    return ref._run(lambda j: bark_tpu_batch_lanes(j, prompts), seed,
                    weights, False, {})[0]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every rank's results (the two spawns, run in the background) and
    bark_tpu's references (computed meanwhile), keyed by name; the dry run
    of 4 CPU ranks in a subprocess, started when the spawns end."""
    d = tmp_path_factory.mktemp("sharding")
    q128 = str(d / "tiny128_q8.bin")
    ggml.write_model_file(str(d / "tiny128.bin"),
                          build_tiny_model(n_embd=128))
    assert bark_tpu_torch.bark_model_quantize(
        str(d / "tiny128.bin"), q128, ggml.GGMLFType.MOSTLY_Q8_0)
    params, inputs = _mesh_arrays(str(d / "mesh.npz"))
    noise = {}
    jobs = {2: [], 4: []}
    for name, world, mode, weights, kw, seed, prompts, replay in BATCHES:
        if replay and (seed, len(prompts)) not in noise:
            noise[seed, len(prompts)] = _record_noise(
                str(d / f"noise_{seed}_{len(prompts)}.npz"), seed,
                len(prompts))
        jobs[world].append(dict(
            model=ref.weights(weights), params=_port_params(
                dequantize_on_load=weights == "f32", **kw),
            seed=seed, texts=prompts, mode=mode, dp=2,
            noise=noise[seed, len(prompts)] if replay else None))
    default = dict(model=ref.weights(), params=_port_params(),
                   seed=DEFAULT_NOISE, texts=P4)
    jobs[2] += [dict(default, mode="dp"), dict(default, mode=None)]
    calls = {2: [("serve", jobs[2])],
             4: [("mesh_report", dict(n=4, dp=2, cfg=CFG,
                                      arrays=str(d / "mesh.npz"),
                                      qpack_model=q128)),
                 ("serve", jobs[4])]}
    port, errors = {}, []

    def run(world):
        try:
            port[world] = launch.spawn(ranks.run, world, "cpu", calls[world])
        except Exception as exc:  # re-raised below, in the fixture
            errors.append(exc)

    def dryrun():
        for t in threads:
            t.join(timeout=600)
        dry.append(subprocess.run(
            [sys.executable, "-m", "bark_tpu_torch.parallel.dryrun", "4",
             "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=ROOT), timeout=600))

    threads = [threading.Thread(target=run, args=(w,)) for w in (2, 4)]
    dry, dry_thread = [], threading.Thread(target=dryrun)
    for t in threads + [dry_thread]:
        t.start()
    jax_ref = dict(factories=_jax_factories(params, inputs),
                   qpack_shapes=_jax_qpack_shapes(q128))
    for name, world, mode, weights, kw, seed, prompts, _ in BATCHES:
        key = (weights, tuple(sorted(kw.items())), seed, tuple(prompts))
        if key not in jax_ref:
            jax_ref[key] = _jax_batch(name, weights, kw, seed, prompts)
        jax_ref[name] = jax_ref[key]
    for t in threads + [dry_thread]:
        t.join(timeout=1200)
    if errors:
        raise errors[0]
    results = {}
    for world in (2, 4):
        per_rank = port[world]
        serve = [r[-1] for r in per_rank]  # the serve call's, rank by rank
        names = [b[0] for b in BATCHES if b[1] == world]
        if world == 2:
            names += ["dp2-default", "unsharded-default"]
        for i, name in enumerate(names):
            results[name] = [s[i] for s in serve]
        if world == 4:
            results["report"] = [r[0] for r in per_rank]
    return dict(port=results, jax=jax_ref, params=params, inputs=inputs,
                dry=dry[0] if dry else None)


# ----------------------------------------------------------------- the mesh


def test_make_mesh_refuses_dp_not_dividing_n():
    """The JAX function's ValueError, before any process group is asked."""
    with pytest.raises(ValueError, match="not divisible by dp=3"):
        sharding.make_mesh(8, dp=3)
    with pytest.raises(ValueError):
        jsharding.make_mesh(8, dp=3)


def test_mesh_shapes_and_coords(worlds):
    """make_mesh(4, dp=2) places rank r at (r // 2, r % 2), as
    np.reshape(dp, tp) places bark_tpu's devices; make_dp_mesh takes every
    rank on one axis."""
    reports = worlds["port"]["report"]
    jmesh = jsharding.make_mesh(4, dp=2)
    for r, rep in enumerate(reports):
        assert rep["mesh"] == dict(jmesh.shape) == {"dp": 2, "tp": 2}
        assert rep["coord"] == (r // 2, r % 2)
        assert rep["dp_mesh"] == {"dp": 4}
        assert "not divisible by dp=3" in rep["bad_dp"]


# ---------------------------------------------------------------- the specs


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_specs_equal_bark_tpu():
    """gpt_param_specs, kv_cache_spec and the qpack tables, entry by entry,
    as tuples of axis names equal to bark_tpu's PartitionSpecs."""
    cfg = GPTConfig(**CFG)
    port = dict(_flat(sharding.gpt_param_specs(cfg)))
    want = dict(_flat(jsharding.gpt_param_specs(jgpt.GPTConfig(**CFG))))
    assert port.keys() == want.keys()
    for k in want:
        assert port[k] == tuple(want[k]), k
    for batched in (False, True):
        assert sharding.kv_cache_spec(batched) == tuple(
            jsharding.kv_cache_spec(batched))
    for mine, theirs in ((sharding._QPACK_SPECS, jsharding._QPACK_SPECS),
                         (sharding._QPACK_BLOCK_SPECS,
                          jsharding._QPACK_BLOCK_SPECS)):
        assert mine.keys() == theirs.keys()
        for k, (spec, blocked) in theirs.items():
            assert mine[k] == (tuple(spec), blocked), k


# --------------------------------------------------------------- the shards


def test_param_shards_have_bark_tpus_shapes(worlds):
    """Every rank's shard of every leaf has the shape of bark_tpu's
    addressable shard at (dp 2, tp 2): qkv_w (2, 64, 96), norms whole."""
    want = worlds["jax"]["factories"]["shapes"]
    for rep in worlds["port"]["report"]:
        assert rep["shapes"] == want
    assert want["blocks/qkv_w"] == (2, 64, 96)
    assert want["ln_f_g"] == (64,)


def test_qkv_shards_hold_their_heads_columns(worlds):
    """Rank t's qkv_w and qkv_b columns are its heads' q, k and v columns,
    [t*D/tp, (t+1)*D/tp) of each (not bark_tpu's contiguous chunk)."""
    D, w = CFG["n_embd"], CFG["n_embd"] // 2
    blocks = worlds["params"]["blocks"]
    for rep in worlds["port"]["report"]:
        t = rep["coord"][1]
        cols = np.concatenate([np.arange(c * D + t * w, c * D + (t + 1) * w)
                               for c in range(3)])
        np.testing.assert_array_equal(rep["qkv_w"], blocks["qkv_w"][..., cols])
        np.testing.assert_array_equal(rep["qkv_b"], blocks["qkv_b"][..., cols])


def test_qpack_shards_have_bark_tpus_shapes(worlds):
    """A q8_0 qpack (width 128) shards its int8 values and their scales
    as bark_tpu does: qkv and fc column-parallel, proj and out
    row-parallel on whole 32-value blocks, the head by vocab."""
    want = worlds["jax"]["qpack_shapes"]
    for rep in worlds["port"]["report"]:
        assert rep["qpack_shapes"] == want
    assert want["proj_q"] == (2, 64, 128) and want["proj_s"] == (2, 2, 128)


# -------------------------------------------------------- the step factories


@pytest.mark.parametrize("what", ["decode", "prefill", "decode2"])
def test_step_factories_match_bark_tpu(worlds, what):
    """make_batched_decode_step and make_batched_prefill at (dp 2, tp 2):
    every rank's logits of every lane within 2e-5 of bark_tpu's on its
    (2, 2) mesh (decode on fresh caches; a prefill of lanes of 8 and 5
    rows; a decode step after it)."""
    want = worlds["jax"]["factories"][what]
    for rep in worlds["port"]["report"]:
        assert rep[what].shape == want.shape
        np.testing.assert_allclose(rep[what], want, rtol=2e-5, atol=2e-5)


def test_step_factories_on_int8_caches(worlds):
    """The prefill and the step after it on int8 caches at (dp 2, tp 2):
    each rank's row scales are those of the whole rows (amax reduced over
    the tp ranks' heads), as the port's single-device int8 path writes
    them, and its logits within 1e-3 of that path's (bark_tpu's factories
    take no int8 cache)."""
    from bark_tpu_torch.io import loader as tloader
    from bark_tpu_torch.models import gpt as tgpt

    cfg = GPTConfig(**CFG)
    params = tloader.params_from_numpy(worlds["params"], torch.float32,
                                       "cpu")
    inputs = worlds["inputs"]
    refs = []
    for b, n in enumerate(inputs["n_valid"]):
        kc, vc = tgpt.init_kv_cache(cfg, torch.float32, "cpu", quant=True)
        pre = tgpt.prefill(cfg, params, torch.from_numpy(inputs["x_emb"][b]),
                           kc, vc, int(n))
        dec = tgpt.decode_step(cfg, params, int(inputs["tokens2"][b]), kc,
                               vc, 8)
        refs.append((pre.numpy(), dec.numpy(), kc["s"], vc["s"]))
    for rep in worlds["port"]["report"]:
        lo, hi = rep["lanes"]
        for i, b in enumerate(range(lo, hi)):
            pre, dec, ks, vs = refs[b]
            np.testing.assert_allclose(rep["prefill_int8"][b], pre, atol=1e-3)
            np.testing.assert_allclose(rep["decode2_int8"][b], dec, atol=1e-3)
            for got, want in zip(rep["scales_int8"], (ks, vs)):
                np.testing.assert_allclose(got[:, i, :9], want[:, :9].numpy(),
                                           rtol=1e-5, atol=0)


# ------------------------------------------------------------- the batches


def _lanes_match(lanes, jaudio, jlanes, atol):
    assert len(lanes) == len(jlanes)
    for b, (t, j) in enumerate(zip(lanes, jlanes)):
        for stage in STAGES:
            assert t[stage].size > 0, (b, stage)
            np.testing.assert_array_equal(t[stage], j[stage],
                                          err_msg=f"lane {b} {stage}")
        assert t["audio"].shape == jaudio[b].shape
        np.testing.assert_allclose(t["audio"], jaudio[b], rtol=0, atol=atol,
                                   err_msg=f"lane {b}")


@pytest.mark.parametrize("name", [b[0] for b in BATCHES])
def test_batch_matches_bark_tpu(worlds, name):
    """Each batch on the mesh: every lane's tokens equal to bark_tpu's
    batch on the same weights and keys, its audio within DP_ATOL (dp) or
    TP_ATOL (tp), every rank returning every lane; the dp batches ran the
    batched kernels' plain versions, the tp ones the tensor-parallel
    forward and no kernel's plain version."""
    per_rank = worlds["port"][name]
    jaudio, jlanes = worlds["jax"][name]
    mode = dict((b[0], b[2]) for b in BATCHES)[name]
    for r in per_rank:
        _lanes_match(r["lanes"], jaudio, jlanes,
                     DP_ATOL if mode == "dp" else TP_ATOL)
        assert r["forward"] == ("kernels" if mode == "dp"
                                else "tensor-parallel")
    plain = [r["plain_calls"] for r in per_rank]
    assert any(plain) if mode == "dp" else not any(plain), plain
    assert per_rank[0]["mesh"] == ({"dp": 2, "tp": 2} if mode == "tp" else
                                   {"dp": len(per_rank)})


def test_dp_batch_equals_the_ports_unsharded_batch(worlds):
    """Under the default noise source (one generator, stage-major draws)
    the dp ranks draw every lane's noise in the unsharded order: each lane
    is bit-equal to the port's unsharded batch, its statistics too."""
    dp = worlds["port"]["dp2-default"]
    single = worlds["port"]["unsharded-default"][0]
    for r in dp:
        for t, u in zip(r["lanes"], single["lanes"]):
            for key in STAGES + ("audio",):
                np.testing.assert_array_equal(t[key], u[key], err_msg=key)
        for f in ("n_sample_semantic", "n_sample_coarse", "n_sample_fine"):
            assert r["stats"][f] == single["stats"][f] > 0, f


# --------------------------------------------- a world of 1, in this process


@pytest.fixture(scope="module")
def world1():
    with launch.process_group(1, 0, "cpu") as dev:
        yield dev


def _tiny(seed: int):
    return bark_tpu_torch.bark_load_model(ref.weights(), tiny_params(),
                                          seed=seed, device="cpu")


def test_world_of_one_serves_the_unsharded_batch(world1):
    """A world of 1: shard_context_dp gives the unsharded batch bit for
    bit; shard_context at tp 1 gives its tokens, its audio within TP_ATOL,
    and refuses a single request."""
    base = _tiny(3)._generate_batch(P3)
    dp = sharding.shard_context_dp(_tiny(3), sharding.make_dp_mesh())
    tpc = sharding.shard_context(_tiny(3), sharding.make_mesh(1))
    assert isinstance(tpc._forward, tp.TensorParallelForward)
    for lanes, atol in ((dp._generate_batch(P3), 0),
                        (tpc._generate_batch(P3), TP_ATOL)):
        for t, u in zip(lanes, base):
            for stage in STAGES:
                np.testing.assert_array_equal(t[stage], u[stage])
            np.testing.assert_allclose(t["audio"], u["audio"], rtol=0,
                                       atol=atol)
    with pytest.raises(ValueError, match="generate_audio_batch"):
        tpc.generate_audio("hello world")
    with pytest.raises(ValueError, match="generate_audio_batch"):
        next(iter(tpc.generate_audio_stream("hello world")))


def test_mesh_takes_every_rank(world1):
    with pytest.raises(ValueError, match="every rank"):
        sharding.make_mesh(2, dp=1)


# ------------------------------------------------- failures and the dry run


def test_a_failing_rank_fails_the_spawn():
    """A rank that raises fails the whole run with its traceback; nothing
    carries on without it."""
    with pytest.raises(RuntimeError, match="mode 'bogus'") as info:
        launch.spawn(ranks.run, 2, "cpu", [("serve", [dict(
            model=ref.weights(), params=_port_params(), texts=P3,
            mode="bogus")])])
    assert "Traceback" in str(info.value)


def test_dryrun_exits_0(worlds):
    """python -m bark_tpu_torch.parallel.dryrun 4 --device cpu: one
    prefill and one decode step at (dp 2, tp 2), shard_context on the tiny
    pipeline and shard_context_dp on 4 prompts."""
    out = worlds["dry"]
    assert out is not None and out.returncode == 0, out and out.stderr
    assert "dryrun(4) OK" in out.stdout
