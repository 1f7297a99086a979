"""GAN / VAE losses (port of wetts_tpu/train/losses.py; reference
wetts/vits/losses.py:6-60): LS-GAN discriminator and generator losses,
x2-scaled feature matching, and the VITS KL between the flow-mapped
posterior and the aligned prior. All computed in float32.

Inside a data-parallel step the KL divides by the global batch's mask sum
(`parallel.mesh.global_sum`), so that each rank's value is its share of
the global loss.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from wetts_tpu_torch.parallel.mesh import global_sum


def feature_loss(fmap_r: Sequence[Sequence[torch.Tensor]],
                 fmap_g: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.float().detach()
                                               - gl.float()))
    return loss * 2


def discriminator_loss(disc_real: Sequence[torch.Tensor],
                       disc_gen: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                  List[torch.Tensor]]:
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real, disc_gen):
        r_loss = torch.mean((1.0 - dr.float()) ** 2)
        g_loss = torch.mean(dg.float() ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        l = torch.mean((1.0 - dg.float()) ** 2)
        gen_losses.append(l)
        loss = loss + l
    return loss, gen_losses


def kl_loss(z_p: torch.Tensor, logs_q: torch.Tensor, m_p: torch.Tensor,
            logs_p: torch.Tensor, z_mask: torch.Tensor) -> torch.Tensor:
    """All inputs [B, T, C] (channel-last); z_mask [B, T, 1]. The mask has a
    singleton channel, so sum(z_mask) counts valid frames only (of the
    global batch inside a data-parallel step)."""
    z_p, logs_q, m_p, logs_p, z_mask = (
        t.float() for t in (z_p, logs_q, m_p, logs_p, z_mask))
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / global_sum(torch.sum(z_mask))
