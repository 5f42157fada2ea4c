"""The batched fine stage and codec of bark_tpu_torch against the JAX
package's vmapped fine and EnCodec programs (`bark_tpu/api/context.py`
builds `jax.vmap(fine, in_axes=(None, 0, 0, 0, 0, 0))` and
`jax.vmap(encodec.decode_codes, in_axes=(None, 0))`), on the tiny model of
tests/tiny_model.py, f32 on the CPU:

- `gpt.fine_forward` over (B, T, C) lanes against the vmapped JAX forward
  (logits within 1e-5: another summation order);
- the fine stage program over four lanes, with n_frames inside one block,
  across two and across several, and fine histories of 0, 5 and 512 rows,
  against the vmapped `make_fine_stage_program`: tokens bit-equal at
  fine_temp 0, and at 0.5 with each lane's key replayed as its noise
  (`gumbel_from_key`); each lane bit-equal to the same program on that
  lane alone; one `forward.fine` call a fine codebook and block of the
  longest lane (not a lane); the block program's lanes each as alone;
- the codec's batched functions against their vmapped JAX counterparts
  (1e-5), and `BarkContext._decode_codecs` (one decode a group of lanes of
  one decode length) against JAX's decode of the lanes padded to the
  longest lane's bucket, and of a lane under kernel_size at its exact
  length (audio within 1e-4);
- `generate_audio_batch` of lanes that stop at different semantic steps:
  its fine stage calls `forward.fine` (n_fine - n_coarse) x the longest
  lane's blocks times and the codec once a decode length.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bark_tpu_torch
from bark_tpu.io import ggml
from bark_tpu.io import loader as jloader
from bark_tpu.models import encodec as jenc
from bark_tpu.models import gpt as jgpt
from bark_tpu.pipeline import fine as jfine
from bark_tpu.pipeline.voice import FINE_HISTORY_MAX
from bark_tpu_torch.io import loader as tloader
from bark_tpu_torch.models import encodec as tenc
from bark_tpu_torch.models import gpt as tgpt
from bark_tpu_torch.pipeline import fine as tfine
from bark_tpu_torch.pipeline import forward as tforward

from test_torch_e2e import gumbel_from_key, one_torch_thread  # autouse
from tiny_model import CODEBOOK, build_tiny_model, tiny_params

ATOL = 1e-5
AUDIO_ATOL = 1e-4
# (n_frames, fine history rows) a lane: one block, two (history 5), four,
# and 16 (a whole 512-row history)
LANES = [(20, 0), (80, 5), (150, 0), (30, FINE_HISTORY_MAX)]
MAX_FRAMES = max(n for n, _ in LANES)
# the JAX package's batched codec program (`bark_tpu/api/context.py:513`)
VMAPPED_DECODE = jax.jit(jax.vmap(jenc.decode_codes, in_axes=(None, 0)))


@pytest.fixture(scope="module")
def model():
    return build_tiny_model()


@pytest.fixture(scope="module")
def fine(model):
    """(JAX cfg, JAX params, port cfg, port params) of the fine stage."""
    jcfg, jp = jloader.gpt_params_from_section(model.fine, jnp.float32)
    tcfg, tp = tloader.gpt_params_from_section(model.fine, torch.float32,
                                               "cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def lanes():
    """Each lane's coarse codes (MAX_FRAMES, 2) and (512, 8) history
    buffer, its first rows the history."""
    rng = np.random.RandomState(11)
    out = []
    for n, n_hist in LANES:
        codes = rng.randint(0, CODEBOOK, (MAX_FRAMES, 2)).astype(np.int32)
        hist = np.full((FINE_HISTORY_MAX, 8), CODEBOOK, np.int32)
        hist[:n_hist] = rng.randint(0, CODEBOOK, (n_hist, 8))
        out.append((codes, n, hist, n_hist))
    return out


class CountingForward(tforward.KernelForward):
    """The kernels' forward, counting `fine` calls and their lanes."""

    def __init__(self):
        self.fine_lanes = []

    def fine(self, cfg, params, tokens, codebook_idx: int):
        self.fine_lanes.append(tokens.shape[0])
        return super().fine(cfg, params, tokens, codebook_idx)


def test_fine_forward_lanes_match_vmapped_jax(fine):
    jcfg, jp, tcfg, tp = fine
    toks = np.random.RandomState(3).randint(
        0, CODEBOOK + 1, (3, tcfg.block_size, 8)).astype(np.int32)
    for idx in (2, 7):
        j = jax.jit(jax.vmap(lambda t, i=idx: jgpt.fine_forward(
            jcfg, jp, t, i)))(jnp.asarray(toks))
        t = tgpt.fine_forward(tcfg, tp, torch.from_numpy(toks), idx)
        assert tuple(t.shape) == (3, tcfg.block_size, tcfg.n_out_vocab)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL)


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["temp0", "temp0.5"])
def stage(request, fine, lanes):
    """The JAX package's vmapped fine stage and the port's over LANES at
    one fine_temp, the port's noise each lane's JAX key replayed: (JAX
    tokens, port tokens, forward, port program, noise)."""
    jcfg, jp, tcfg, tp = fine
    p = tiny_params(fine_temp=request.param)
    keys = jax.random.split(jax.random.PRNGKey(7), len(LANES))
    jprog = jax.jit(jax.vmap(
        jfine.make_fine_stage_program(jcfg, p, max_frames=MAX_FRAMES),
        in_axes=(None, 0, 0, 0, 0, 0)))
    jout = np.asarray(jprog(
        jp, jnp.asarray(np.stack([c for c, _, _, _ in lanes])),
        jnp.asarray([n for _, n, _, _ in lanes], jnp.int32), keys,
        jnp.asarray(np.stack([h for _, _, h, _ in lanes])),
        jnp.asarray([nh for _, _, _, nh in lanes], jnp.int32)))
    noise = None
    if request.param:
        noise = [gumbel_from_key("fine", keys[b], (
            tfine.fine_schedule(nh + n, tcfg.block_size)[1], 6,
            tcfg.block_size, CODEBOOK))
            for b, (_, n, _, nh) in enumerate(lanes)]
    fwd = CountingForward()
    prog = tfine.make_fine_stage_program(tcfg, p, forward=fwd)
    tout = prog(tp, [torch.from_numpy(c) for c, _, _, _ in lanes],
                [n for _, n, _, _ in lanes], noise,
                [torch.from_numpy(h[:nh]) for _, _, h, nh in lanes])
    return jout, tout, fwd, prog, noise


def test_fine_stage_lanes_equal_vmapped_jax(stage, lanes):
    """Every lane's tokens bit-equal to the JAX package's vmapped stage,
    the history rows shifted out as there."""
    jout, tout, _, _, _ = stage
    assert len(tout) == len(LANES)
    for b, (t, (_, n, _, n_hist)) in enumerate(zip(tout, lanes)):
        padded = tfine.fine_schedule(n_hist + n, 64)[0]
        assert tuple(t.shape) == (padded - n_hist, 8), b
        np.testing.assert_array_equal(t[:n].numpy(), jout[b, :n],
                                      err_msg=f"lane {b}")
        assert (t[:n] < CODEBOOK).all()


def test_fine_stage_lanes_equal_lanes_alone(stage, fine, lanes):
    """Each lane of the batch bit-equal to the same program on that lane
    alone; the batch makes one forward a fine codebook and block of its
    longest lane (16 blocks: the 512-row history), each over the lanes
    still refining (4, 3, 2 and then 1)."""
    _, tout, fwd, prog, noise = stage
    tp = fine[3]
    assert fwd.fine_lanes == [4] * 6 + [3] * 6 + [2] * 12 + [1] * 72
    for b, (codes, n, hist, n_hist) in enumerate(lanes):
        alone = prog(tp, [torch.from_numpy(codes)], [n],
                     None if noise is None else [noise[b]],
                     [torch.from_numpy(hist[:n_hist])])[0]
        torch.testing.assert_close(tout[b], alone, rtol=0, atol=0)


def test_block_program_keeps_each_lanes_rows(fine):
    """The block program over 3 lanes with fills at rows 0, 17 and 40 (a
    stream's block is a batch of one): each lane bit-equal to itself
    alone, its rows before its fill and its coarse columns as they went
    in."""
    _, _, tcfg, tp = fine
    refine = tfine.make_fine_block_program(tcfg, tiny_params(fine_temp=0.5))
    rng = np.random.RandomState(5)
    buf = torch.from_numpy(rng.randint(0, CODEBOOK, (3, 64, 8)).astype(
        np.int32))
    noise = torch.from_numpy(rng.gumbel(size=(3, 6, 64, CODEBOOK)).astype(
        np.float32))
    rel = [0, 17, 40]
    out = refine(tp, buf, rel, noise)
    for b in range(3):
        alone = refine(tp, buf[b:b + 1], rel[b:b + 1], [noise[b]])[0]
        torch.testing.assert_close(out[b], alone, rtol=0, atol=0)
        torch.testing.assert_close(out[b, :rel[b]], buf[b, :rel[b]],
                                   rtol=0, atol=0)
        torch.testing.assert_close(out[b, :, :2], buf[b, :, :2], rtol=0,
                                   atol=0)
    assert not torch.equal(out[0, :, 2:], buf[0, :, 2:])


@pytest.fixture(scope="module")
def codec(model):
    return (jenc.params_from_section(model.codec),
            tloader.codec_params_from_section(model.codec, "cpu"))


def _rnd(*shape, seed=0):
    return (np.random.RandomState(seed).randn(*shape) * 0.5).astype(
        np.float32)


def test_codec_functions_take_lanes(codec):
    """causal_conv1d (stride 1 and 2, dilation 3), the transposed conv,
    the LSTM stack and the whole SEANet decoder on 3 lanes (the lanes as
    one batch, as they run on a CUDA tensor) against jax.vmap of the JAX
    package's functions."""
    jp, tp = codec
    x = _rnd(3, 17, 5)
    w = _rnd(6, 5, 4, seed=1)
    b = np.linspace(-1, 1, 6).astype(np.float32)
    for stride, dil in ((1, 1), (2, 1), (1, 3)):
        j = jax.jit(jax.vmap(lambda xi, s=stride, d=dil: jenc.causal_conv1d(
            xi, jnp.asarray(w), jnp.asarray(b), s, d)))(jnp.asarray(x))
        t = tenc.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b), stride, dil)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=ATOL)
    wt = _rnd(5, 3, 8, seed=2)
    j = jax.jit(jax.vmap(lambda xi: jenc.causal_conv_transpose1d(
        xi, jnp.asarray(wt), jnp.asarray(b[:3]), 4)))(jnp.asarray(x))
    t = tenc.causal_conv_transpose1d(torch.from_numpy(x),
                                     torch.from_numpy(wt),
                                     torch.from_numpy(b[:3]), 4)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)
    x = _rnd(3, 30, 32, seed=3)
    j = jax.jit(jax.vmap(lambda xi: jenc.lstm_stack(
        xi, jp["decoder"]["lstm"])))(jnp.asarray(x))
    t = tenc.lstm_stack(torch.from_numpy(x), tp["decoder"]["lstm"])
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)
    codes = np.random.RandomState(4).randint(0, CODEBOOK, (3, 20, 8)).astype(
        np.int32)
    latent = tenc.rvq_decode(tp["quantizer"], torch.from_numpy(codes))
    assert tuple(latent.shape) == (3, 20, 16)
    j = VMAPPED_DECODE(jp, jnp.asarray(codes))
    t = tenc._decode(tp["decoder"], latent.transpose(1, 2))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                               atol=AUDIO_ATOL)
    np.testing.assert_array_equal(
        tenc.decode_codes(tp, torch.from_numpy(codes)).numpy()[1],
        tenc.decode_codes(tp, torch.from_numpy(codes[1])).numpy())


@pytest.fixture(scope="module")
def ctx(tmp_path_factory, model):
    path = str(tmp_path_factory.mktemp("tiny") / "ggml_weights.bin")
    ggml.write_model_file(path, model)
    return path, bark_tpu_torch.bark_load_model(path, tiny_params(), seed=0,
                                                device="cpu")


def test_codec_groups_match_vmapped_jax(ctx, codec, monkeypatch):
    """Lanes of 150, 4, 90 and 135 frames decode as one call a decode
    length (256: two lanes; 4 frames exactly; 128), each lane's audio
    within 1e-4 of JAX's vmapped decode of every lane padded to the
    longest lane's bucket (256), and the short lane's of its exact
    decode."""
    _, tctx = ctx
    jp, _ = codec
    frames = [150, 4, 90, 135]
    rng = np.random.RandomState(9)
    bufs = [rng.randint(0, CODEBOOK, (n, 8)).astype(np.int32)
            for n in frames]
    calls = []
    decode = tenc.decode_codes
    monkeypatch.setattr(tenc, "decode_codes", lambda params, codes: (
        calls.append(tuple(codes.shape)) or decode(params, codes)))
    got = tctx._decode_codecs([torch.from_numpy(f) for f in bufs], frames)
    assert sorted(calls) == [(2, 256, 8), (4, 8), (128, 8)]
    padded = np.full((len(frames), 256, 8), CODEBOOK, np.int32)
    for b, f in enumerate(bufs):
        padded[b, :len(f)] = f
    j = np.asarray(VMAPPED_DECODE(jp, jnp.asarray(padded)))
    for b, n in enumerate(frames):
        want = (np.asarray(jax.jit(jenc.decode_codes)(
            jp, jnp.asarray(bufs[b])))
                if n < tctx.codec_cfg.kernel_size else j[b, :n * 320])
        assert tuple(got[b].shape) == (n * 320,)
        np.testing.assert_allclose(got[b].numpy(), want, rtol=0,
                                   atol=AUDIO_ATOL, err_msg=f"lane {b}")
        np.testing.assert_array_equal(
            got[b].numpy(), tctx._decode_codec(torch.from_numpy(bufs[b]),
                                               n).numpy())


# semantic_vocab_size 10 makes token 10 the stop token; forced noise picks
# it at each lane's stop step and never before (None: the lane runs all
# 100 steps)
STOP_AT = [None, 3, 60, 90]


def _forced_noise(stage, lane, shape):
    gen = torch.Generator().manual_seed(100 * lane + len(stage))
    noise = -torch.log(-torch.log(torch.rand(shape, generator=gen)))
    if stage == "semantic":
        noise[:, 10] = -1e4
        if STOP_AT[lane] is not None:
            noise[STOP_AT[lane], 10] = 1e4
    return noise


def test_batch_runs_fine_and_codec_across_lanes(ctx, monkeypatch):
    """A batch whose lanes stop after 100, 3, 60 and 90 semantic tokens
    (150, 4, 90 and 135 frames: 4, 1, 2 and 4 fine blocks): each fine
    block's 6 forwards run once for the lanes still refining, 24 in all,
    and the codec once a decode length (256, 128, and the 4-frame lane
    exactly: 3 calls); each lane's audio is its single decode's."""
    path, _ = ctx
    p = tiny_params(semantic_vocab_size=10, temp=0.7, fine_temp=0.5,
                    n_steps_text_encoder=100)
    bctx = bark_tpu_torch.bark_load_model(path, p, seed=0, device="cpu")
    bctx._forward = fwd = CountingForward()
    bctx.lane_noise_source = _forced_noise
    calls = []
    decode = tenc.decode_codes
    monkeypatch.setattr(tenc, "decode_codes", lambda params, codes: (
        calls.append(tuple(codes.shape[:-1])) or decode(params, codes)))
    out = bctx._generate_batch(["hello world", "the a", "world the",
                                "a hello the"])
    frames = [lane["fine"].shape[0] for lane in out]
    assert frames == [150, 4, 90, 135]
    assert fwd.fine_lanes == [4] * 6 + [3] * 6 + [2] * 12
    assert sorted(calls) == [(2, 256), (4,), (128,)]
    for lane, n in zip(out, frames):
        np.testing.assert_array_equal(
            lane["audio"], bctx._decode_codec(
                torch.from_numpy(lane["fine"]), n).numpy())
    assert bctx.stats.n_sample_fine == sum(frames) * 8
