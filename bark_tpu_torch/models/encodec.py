"""EnCodec 24 kHz in plain PyTorch, f32: the decode path (RVQ codebook sum
+ SEANet decoder) and the compression path (SEANet encoder + greedy RVQ),
which voice presets from audio run (`pipeline.voice.preset_from_audio`).

The counterpart of `bark_tpu.models.encodec`, with its
layouts at every public function: activations are (T, C), conv weights
keep torch's (Cout, Cin, K) and transposed-conv weights (Cin, Cout, K).
The decode path's functions also take a leading lane dimension, (B, T, C)
codes or activations, each lane computed as alone (the JAX package's
`jax.vmap` of `decode_codes`; on the CPU `decoder_forward` runs them
one at a time). Inside, the ops run in torch's (B, C, T) layout for
`F.conv1d`, `F.conv_transpose1d` and `torch.lstm` (batch B), a single
lane as a batch of one (the JAX package leaves this stage to
XLA, so it has no kernel to port). All convolutions are causal: reflect
padding of `k_eff - stride` on the left, and transposed convs trim
`k - stride` on the right.
"""

from __future__ import annotations

import warnings
from typing import Dict, List

import torch
import torch.nn.functional as F

from bark_tpu_torch.models.config import RATIOS


def _bct(x):
    """([B,] T, C) -> ((B, C, T) view, whether x had no lane dimension)."""
    one = x.dim() == 2
    return (x[None] if one else x).transpose(1, 2), one


def _tc(y, one: bool):
    """(B, C, T) -> ([B,] T, C), the inverse of `_bct`."""
    y = y.transpose(1, 2)
    return y[0] if one else y


def _pad_reflect(x, pad_left: int, pad_right: int):
    """Reflect padding over the time axis of (B, C, T); a signal shorter
    than the largest pad is zero-extended first so the reflection is
    defined, and the extension is trimmed afterwards."""
    T = x.shape[-1]
    max_pad = max(pad_left, pad_right)
    extra = max_pad - T + 1 if T <= max_pad else 0
    if extra:
        x = F.pad(x, (0, extra))
    y = F.pad(x, (pad_left, pad_right), mode="reflect")
    return y[..., : y.shape[-1] - extra] if extra else y


def _conv(x, w, b, stride: int = 1, dilation: int = 1):
    """Causal conv of (B, Cin, T) -> (B, Cout, T')."""
    k = w.shape[2]
    k_eff = (k - 1) * dilation + 1
    pad_total = k_eff - stride
    T = x.shape[-1]
    n_frames = -(-(T - k_eff + pad_total) // stride)  # ceil
    ideal = n_frames * stride + k_eff - pad_total
    x = _pad_reflect(x, pad_total, max(ideal - T, 0))
    return F.conv1d(x, w, b, stride=stride, dilation=dilation)


def _conv_tr(x, w, b, stride: int):
    """Causal transposed conv of (B, Cin, T) -> (B, Cout, T*stride)."""
    k = w.shape[2]
    out = F.conv_transpose1d(x, w, b, stride=stride)
    trim = k - stride
    return out[..., : out.shape[-1] - trim] if trim > 0 else out


def _lstm(x, layers: List[Dict]):
    """Multi-layer LSTM over (B, C, T), the lanes as torch.lstm's batch
    (gates i, f, g, o; b_ih + b_hh), plus EnCodec's skip connection."""
    flat = []
    for lp in layers:
        flat += [lp["w_ih"].float(), lp["w_hh"].float(),
                 lp["b_ih"].float(), lp["b_hh"].float()]
    H = layers[0]["w_hh"].shape[1]
    xt = x.float().transpose(1, 2)  # (B, T, C)
    h0 = torch.zeros((len(layers), xt.shape[0], H), device=x.device)
    with warnings.catch_warnings():
        # cuDNN copies the separate weight tensors into one buffer per call
        # (a few MB, once per utterance) and warns about it
        warnings.filterwarnings("ignore", message="RNN module weights")
        y, _, _ = torch.lstm(
            xt, (h0, h0), flat, True, len(layers), 0.0, False, False, True,
        )
    return (y + xt).to(x.dtype).transpose(1, 2)


def causal_conv1d(x, w, b, stride: int = 1, dilation: int = 1):
    """x: ([B,] T, Cin); w: (Cout, Cin, K) -> ([B,] T', Cout)."""
    x, one = _bct(x)
    return _tc(_conv(x, w, b, stride, dilation), one)


def causal_conv_transpose1d(x, w, b, stride: int):
    """x: ([B,] T, Cin); w: (Cin, Cout, K) -> ([B,] T*stride, Cout)."""
    x, one = _bct(x)
    return _tc(_conv_tr(x, w, b, stride), one)


def lstm_stack(x, layers: List[Dict]):
    """Multi-layer LSTM over ([B,] T, C) (gates i, f, g, o; b_ih + b_hh)
    plus EnCodec's skip connection."""
    x, one = _bct(x)
    return _tc(_lstm(x, layers), one)


def _residual_unit(x, p):
    """SEANet's residual unit on (B, C, T)."""
    y = F.elu(x)
    y = _conv(y, p["block1_w"], p["block1_b"])
    y = F.elu(y)
    y = _conv(y, p["block3_w"], p["block3_b"])
    return _conv(x, p["shortcut_w"], p["shortcut_b"]) + y


def rvq_decode(codebooks, codes):
    """codebooks: (n_q_total, n_bins, dim); codes: ([B,] T, n_q) ->
    ([B,] T, dim).

    Codes outside [0, n_bins) select a zero row: the fused fine buffer's
    rows past the last frame hold the pad id n_bins, which `jnp.take`
    fills and a torch index would refuse (a device-side assert on CUDA).
    Those rows only reach audio past the last frame, which the causal
    decoder never mixes into earlier samples and callers discard."""
    n_q = codes.shape[-1]
    n_bins = codebooks.shape[1]
    c = codes.long()
    valid = (c >= 0) & (c < n_bins)  # ([B,] T, n_q)
    books = codebooks[:n_q]  # (n_q, n_bins, dim)
    idx = torch.where(valid, c, torch.zeros_like(c))
    gathered = books[torch.arange(n_q, device=c.device), idx]
    gathered = gathered * valid[..., None].to(gathered.dtype)
    return gathered.sum(dim=-2)


def rvq_encode(codebooks, latent, n_q: int):
    """Greedy residual VQ: latent (T, dim) -> codes (T, n_q) int32; each
    book takes the nearest embedding (squared distance, ties to the lowest
    index) to what the earlier books left."""
    residual, codes = latent.float(), []
    for embed in codebooks[:n_q]:
        d = ((residual ** 2).sum(dim=1, keepdim=True)
             - 2.0 * residual @ embed.T
             + (embed ** 2).sum(dim=1)[None, :])
        idx = torch.argmin(d, dim=1)
        residual = residual - embed[idx]
        codes.append(idx)
    return torch.stack(codes, dim=1).to(torch.int32)


def decoder_forward(params, latent):
    """latent ([B,] T, hidden_dim) -> mono PCM ([B,] T * 320) f32. On a
    CUDA tensor the B lanes run as one batch (cuDNN's convolutions and
    LSTM). On the CPU each lane runs as a batch of one, so that its bits
    are a single lane's: oneDNN picks its convolution by the batch size,
    and MKL runs the LSTM's recurrent product of one lane as a GEMV and of
    several as a GEMM, and each rounds differently."""
    if latent.dim() == 3 and latent.device.type == "cpu":
        return torch.stack([decoder_forward(params, lane) for lane in latent])
    x, one = _bct(latent)
    pcm = _decode(params["decoder"], x)
    return pcm[0] if one else pcm


def _decode(dec, x):
    """The SEANet decoder on a (B, hidden_dim, T) latent -> (B, T * 320)
    f32."""
    x = _conv(x, dec["conv_in_w"], dec["conv_in_b"])
    x = _lstm(x, dec["lstm"])
    for stage, r in zip(dec["stages"], RATIOS):
        x = F.elu(x)
        x = _conv_tr(x, stage["convtr_w"], stage["convtr_b"], r)
        x = _residual_unit(x, stage)
    x = F.elu(x)
    x = _conv(x, dec["conv_out_w"], dec["conv_out_b"])
    return x[:, 0].float()


def encoder_forward(params, audio):
    """mono PCM (T,) -> latent (T // 320, hidden_dim)."""
    enc = params["encoder"]
    x = _conv(audio[None, None], enc["conv_in_w"], enc["conv_in_b"])
    for stage, r in zip(enc["stages"], reversed(RATIOS)):
        x = _residual_unit(x, stage)
        x = F.elu(x)
        x = _conv(x, stage["down_w"], stage["down_b"], stride=r)
    x = _lstm(x, enc["lstm"])
    x = F.elu(x)
    return _tc(_conv(x, enc["conv_out_w"], enc["conv_out_b"]), True)


def decode_codes(params, codes):
    """codes ([B,] T, n_q) int -> PCM ([B,] T*320) f32. The text-to-audio
    path; B lanes of one length decode as one batch."""
    return decoder_forward(params, rvq_decode(params["quantizer"], codes))


def encode_audio(params, audio, n_q: int):
    """PCM (T,) f32 -> codes (T // 320, n_q) int32. The compression path;
    the params need the encoder (`io.loader` loads it when the file has
    it)."""
    if "encoder" not in params:
        raise ValueError("encode_audio: these codec params have no encoder "
                         "(the model file holds none)")
    latent = encoder_forward(params, audio.float())
    return rvq_encode(params["quantizer"], latent, n_q)
