"""Film accumulation (counterpart of ppg_tpu/render/film.py, box
reconstruction filter only). The box filter with samples jittered inside
their own pixel lands every sample in that pixel, so a contiguous pixel
chunk splats with one slice add. Unlike the functional JAX version the
flat buffers are updated in place."""

from __future__ import annotations

import torch


class Film:
    """Accumulation buffers: rgb sum and weight sum per pixel."""

    def __init__(self, W, H, rfilter="box", device="cpu"):
        if rfilter != "box":
            raise NotImplementedError(
                f"rfilter {rfilter!r}: only the box filter is ported "
                "(ROADMAP Queue 1, the general rfilter Film.splat)")
        self.W, self.H, self.rfilter = W, H, rfilter
        self.device = device

    def zeros_flat(self, chunk):
        """Flat buffers padded to a whole number of chunks."""
        P = ((self.W * self.H + chunk - 1) // chunk) * chunk
        return (torch.zeros((P, 3), dtype=torch.float32, device=self.device),
                torch.zeros(P, dtype=torch.float32, device=self.device))

    @staticmethod
    def splat_box_linear(buffers, start, values, valid):
        """Adds values [C,3] (where valid [C]) and weight 1 to the C pixels
        from linear offset `start`, in place; returns the buffers."""
        rgb_flat, w_flat = buffers
        C = values.shape[0]
        rgb_flat[start:start + C] += torch.where(valid[:, None], values, 0.0)
        w_flat[start:start + C] += valid.to(torch.float32)
        return rgb_flat, w_flat

    def unflatten(self, buffers):
        rgb_flat, w_flat = buffers
        n = self.W * self.H
        return (rgb_flat[:n].reshape(self.H, self.W, 3),
                w_flat[:n].reshape(self.H, self.W))

    @staticmethod
    def develop(buffers):
        rgb, wsum = buffers
        return rgb / torch.clamp(wsum, min=1e-20)[..., None]
