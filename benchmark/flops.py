"""The work each configuration's inference needs, from its widths alone:
the floating operations of the convolutions, transposed convolutions,
linear maps and attention products, two per multiply-add. Elementwise
operations, the spline, the gather that expands the prior over frames, and
the FFT of the Vocos iSTFT are left out. Nothing here reads the program:
the counts follow the published architecture.

- `request_flops(cfg, n_text, n_frames)`: one request at its realized text
  length and frame count, for the whole model (`mfu`);
- `mrf_stage_cost(...)`: the operations and bytes one HiFi-GAN MRF stage
  needs at a shape (`k1_roofline.*`): 2 * C * C * k per conv tap per
  sample, the input read and the output written once, in f32, and every
  weight and bias read once.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

F32 = 4  # bytes


def conv(c_in: int, c_out: int, k: int, t: int, groups: int = 1) -> int:
    """A convolution producing t positions."""
    return 2 * (c_in // groups) * c_out * k * t


def conv_transpose(c_in: int, c_out: int, k: int, t_in: int) -> int:
    """A transposed convolution over t_in input positions."""
    return 2 * c_in * c_out * k * t_in


def attention(channels: int, t: int, window: int | None) -> int:
    """Self-attention over t positions: the q, k, v and output maps, the
    scores and the weighted sum; with a relative window, its 2w + 1
    key and value embeddings per position."""
    work = 4 * conv(channels, channels, 1, t) + 2 * (2 * t * t * channels)
    if window is not None:
        work += 2 * (2 * t * (2 * window + 1) * channels)
    return work


def encoder(channels: int, filter_channels: int, n_layers: int,
            kernel_size: int, t: int, window: int | None) -> int:
    """The post-norm transformer encoder: attention and a two-conv FFN."""
    ffn = (conv(channels, filter_channels, kernel_size, t)
           + conv(filter_channels, channels, kernel_size, t))
    return n_layers * (attention(channels, t, window) + ffn)


def dds_conv(channels: int, kernel_size: int, t: int, n_layers: int = 3
             ) -> int:
    return n_layers * (conv(channels, channels, kernel_size, t,
                            groups=channels) + conv(channels, channels, 1, t))


def duration_reverse(hidden: int, gin: int, t: int) -> int:
    """The stochastic duration predictor in reverse: the conditioning and
    three ConvFlows (the fourth is dropped in reverse)."""
    cond = (conv(hidden, hidden, 1, t) + conv(gin, hidden, 1, 1)
            + dds_conv(hidden, 3, t) + conv(hidden, hidden, 1, t))
    flow = (conv(1, hidden, 1, t) + dds_conv(hidden, 3, t)
            + conv(hidden, 29, 1, t))
    return cond + 3 * flow


def wn(hidden: int, gin: int, kernel_size: int, n_layers: int, t: int
       ) -> int:
    work = conv(gin, 2 * hidden * n_layers, 1, 1)
    for i in range(n_layers):
        out = 2 * hidden if i < n_layers - 1 else hidden
        work += conv(hidden, 2 * hidden, kernel_size, t) + conv(
            hidden, out, 1, t)
    return work


def flow_reverse(m: dict, t: int) -> int:
    """Four mean-only couplings over t frames."""
    half, hidden, gin = (m["inter_channels"] // 2, m["hidden_channels"],
                         m["gin_channels"])
    coupling = (conv(half, hidden, 1, t) + wn(hidden, gin, 5, 4, t)
                + conv(hidden, half, 1, t))
    if m.get("use_transformer_flows"):
        if m.get("transformer_flow_type") != "pre_conv":
            raise ValueError("only the pre_conv transformer flow is counted")
        coupling += encoder(half, half, 2, 3, t, None)
    return 4 * coupling


def mrf_taps(m: dict) -> int:
    """Taps of one MRF stage: per branch, two convs of kernel k per
    dilation (ResBlock1)."""
    return sum(2 * len(d) * k for k, d in zip(m["resblock_kernel_sizes"],
                                              m["resblock_dilation_sizes"]))


def hifigan_stages(m: dict, t: int) -> Iterator[Tuple[int, int, int, int]]:
    """(input length, output length, input channels, output channels) of
    each upsample stage for t latent frames."""
    c = m["upsample_initial_channel"]
    for u in m["upsample_rates"]:
        yield t, t * u, c, c // 2
        t, c = t * u, c // 2


def decoder(m: dict, t: int) -> int:
    """The decoder over t latent frames."""
    gin = m["gin_channels"]
    if m.get("vocoder_type", "hifigan") == "vocos":
        c, h, f = (m["vocos_channels"], m["vocos_h_channels"], t + 1)
        layer = (conv(c, c, 3, f, groups=c) + conv(c, h, 1, f)
                 + conv(h, c, 1, f))
        return (conv(m["inter_channels"], c, 1, f) + conv(gin, c, 1, 1)
                + m["vocos_num_layers"] * layer
                + conv(c, m["vocos_out_channels"], 1, f))
    c0 = m["upsample_initial_channel"]
    work = conv(m["inter_channels"], c0, 7, t) + conv(gin, c0, 1, 1)
    taps = mrf_taps(m)
    for (t_in, t_out, c_in, c_out), k in zip(hifigan_stages(m, t),
                                             m["upsample_kernel_sizes"]):
        work += conv_transpose(c_in, c_out, k, t_in)
        work += 2 * c_out * c_out * taps * t_out
        last_c, last_t = c_out, t_out
    return work + conv(last_c, 1, 7, last_t)


def request_flops(cfg: dict, n_text: int, n_frames: int) -> int:
    """One request: text encoder and duration predictor over its n_text
    phones, the flow and the decoder over its n_frames frames."""
    m = cfg["model"]
    text = (encoder(m["hidden_channels"], m["filter_channels"],
                    m["n_layers"], m["kernel_size"], n_text, 4)
            + conv(m["hidden_channels"], 2 * m["inter_channels"], 1, n_text)
            + duration_reverse(m["hidden_channels"], m["gin_channels"],
                               n_text))
    return text + flow_reverse(m, n_frames) + decoder(m, n_frames)


def mrf_stage_cost(batch: int, t: int, c: int, kernel_sizes: Sequence[int],
                   dilations: Sequence[Sequence[int]]) -> Tuple[int, int]:
    """(operations, bytes) of one ResBlock1 MRF stage over [batch, t, c] in
    f32."""
    taps = sum(2 * len(d) * k for k, d in zip(kernel_sizes, dilations))
    n_convs = sum(2 * len(d) for d in dilations)
    ops = 2 * c * c * taps * batch * t
    nbytes = F32 * (2 * batch * t * c + c * c * taps + c * n_convs)
    return ops, nbytes


def decoder_mrf_cost(m: dict, batch: int, frames: int) -> Tuple[int, int]:
    """Operations and bytes of every MRF stage of one decoder call over
    [batch, frames] latent frames."""
    ops = nbytes = 0
    for _, t_out, _, c_out in hifigan_stages(m, frames):
        o, b = mrf_stage_cost(batch, t_out, c_out, m["resblock_kernel_sizes"],
                              m["resblock_dilation_sizes"])
        ops, nbytes = ops + o, nbytes + b
    return ops, nbytes
