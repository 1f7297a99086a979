"""The work of the Vocos decoder's backbone (`models/vocos.py`: the in_conv
with the speaker's cond, the ConvNeXt layers and the out_conv, the port's
`vocos` device stage), which `vocos_roofline.*` divides by.

Its operations are benchmark/flops.py's `decoder`, which is affine in the
latent frames t (the backbone runs over t + 1 frames after its reflection
pad): a constant term a row and a term a frame. Its bytes are the input
[rows, inter_channels, t + 1] read and the output [rows, out_channels, t + 1]
written once, and every weight and bias read once a decode, in f32.
"""

from __future__ import annotations

from typing import Tuple

from benchmark.flops import F32, decoder


def weights(m: dict) -> int:
    """Parameters of the backbone: convs' weights and biases, LayerNorms'
    gains and shifts, the layers' scales."""
    c, h, out = (m["vocos_channels"], m["vocos_h_channels"],
                 m["vocos_out_channels"])
    layer = (3 * c + c) + 2 * c + (c * h + h) + (h * c + c) + c
    return ((m["inter_channels"] * c + c) + (m["gin_channels"] * c + c)
            + 2 * c + m["vocos_num_layers"] * layer + 2 * c
            + (c * out + out))


def backbone_cost(m: dict, decodes: int, rows: int, frames: int
                  ) -> Tuple[int, int]:
    """(operations, bytes) of `decodes` decodes that ran `rows` rows in all
    over `frames` latent frames in all (rows x the padded frames of each)."""
    row_ops = decoder(m, 0)
    frame_ops = decoder(m, 1) - row_ops
    ops = rows * row_ops + frames * frame_ops
    per_frame = m["inter_channels"] + m["vocos_out_channels"]
    nbytes = F32 * (per_frame * (frames + rows) + decodes * weights(m))
    return ops, nbytes
