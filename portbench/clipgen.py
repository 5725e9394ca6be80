"""The benchmark's one clip generator: a traffic mix's parameters and a
seed in, a clip of 4:2:0 frames out.

Shaped after bench.py's synth_clip, written in PyTorch and run on the
device in a few large calls: a seeded texture larger than the frame
(sinusoids plus seeded uniform noise), a global pan across
it, an additive wave over the whole frame (the "local motion"), an
optional region of its own texture that moves over the background, an
optional cut period, optional temporal grain, and synth_clip's chroma
waves. Every seed gets the same sizes, speeds and amplitudes; the seed
draws only the noise and each cut's offset.

Mix parameters (JSON; every key optional except `frames`):
  frames                 clip length; a run that needs more frames wraps
                         around, which is a cut
  mean, noise            texture mean and uniform noise half-width
  waves                  [[amplitude, x period px, y period px], ...]
  pan                    [dx, dy] px per frame (whole pixels, floored)
  wave                   {amp, px, rad_per_frame}: amp * sin(x / px +
                         frame * rad_per_frame), over the frame
  region                 {area (share of the frame), start [x, y] (share
                         of the frame), speed [dx, dy] px per frame, mean,
                         noise, waves, wave}: a moving rectangle of its
                         own texture, with its own additive wave
  cut_period, cut_step   every cut_period frames the texture jumps to a
                         seeded offset and its mean moves by cut_step
  grain                  half-width of uniform noise drawn anew each frame
  chroma                 {amp, u_px, u_shift, v_px, v_shift}: synth_clip's
                         u = 128 + amp sin((x + u_shift i) / u_px),
                         v = 128 + amp cos((y + v_shift i) / v_px)
"""

from __future__ import annotations

import math

import torch

CHUNK = 16      # frames made per device call


def _texture(gen, h, w, mean, noise, waves, device):
    """A [h, w] float32 texture: mean + sum of amp sin(x / px)
    cos(y / py) + uniform integer noise in [-noise, noise]."""
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    tex = torch.full((h, w), float(mean), device=device)
    for amp, px, py in waves:
        tex += amp * torch.sin(xx / px) * torch.cos(yy / py)
    if noise:
        tex += torch.randint(-noise, noise + 1, (h, w), generator=gen,
                             device=device).float()
    return tex


def make_clip(mix: dict, width: int, height: int, seed: int,
              device) -> list:
    """The clip of `mix` at width x height from `seed`: a list of frames,
    each [y, u, v] uint8 numpy arrays (4:2:0), made on `device`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n = int(mix["frames"])
    pan = mix.get("pan", [0.0, 0.0])
    cut = int(mix.get("cut_period", 0))
    seg_len = cut if cut else n
    span_x = int(math.floor(abs(pan[0]) * seg_len)) + 1
    span_y = int(math.floor(abs(pan[1]) * seg_len)) + 1
    th, tw = height + span_y, width + span_x
    tex = _texture(gen, th, tw, mix.get("mean", 110), mix.get("noise", 0),
                   mix.get("waves", []), dev)
    n_seg = -(-n // seg_len)
    seg_off = torch.randint(0, 1 << 20, (n_seg, 2), generator=gen,
                            device=dev).tolist()
    region = mix.get("region")
    if region:
        rw = int(round(width * math.sqrt(region["area"]))) // 2 * 2
        rh = int(round(height * math.sqrt(region["area"]))) // 2 * 2
        rtex = _texture(gen, rh, rw, region.get("mean", 110),
                        region.get("noise", 0), region.get("waves", []),
                        dev)
    xx = torch.arange(width, device=dev, dtype=torch.float32)[None, :]
    yy = torch.arange(height, device=dev, dtype=torch.float32)[:, None]
    ch = mix.get("chroma", {"amp": 40, "u_px": 51, "u_shift": 3,
                            "v_px": 47, "v_shift": -2})
    cx = xx[:, ::2]          # chroma samples at even luma positions
    cy = yy[::2]
    wave = mix.get("wave")
    grain = int(mix.get("grain", 0))
    frames = []
    for c0 in range(0, n, CHUNK):
        idx = range(c0, min(n, c0 + CHUNK))
        fy = torch.empty((len(idx), height, width), device=dev)
        for j, i in enumerate(idx):
            seg, k = divmod(i, seg_len)
            dx = int(math.floor(abs(pan[0]) * k))
            dy = int(math.floor(abs(pan[1]) * k))
            ox = dx if pan[0] >= 0 else span_x - 1 - dx
            oy = dy if pan[1] >= 0 else span_y - 1 - dy
            t = tex
            if cut:
                t = torch.roll(tex, (seg_off[seg][1] % th,
                                     seg_off[seg][0] % tw), (0, 1))
                t = t + mix.get("cut_step", 0) * (seg % 3 - 1)
            f = t[oy:oy + height, ox:ox + width].clone()
            if region:
                x0 = int(region["start"][0] * width
                         + math.floor(region["speed"][0] * i))
                y0 = int(region["start"][1] * height
                         + math.floor(region["speed"][1] * i))
                x0 = min(max(x0, 0), width - rw)
                y0 = min(max(y0, 0), height - rh)
                r = rtex
                rwave = region.get("wave")
                if rwave:
                    rx = torch.arange(rw, device=dev,
                                      dtype=torch.float32)[None, :]
                    r = r + rwave["amp"] * torch.sin(
                        rx / rwave["px"] + i * rwave["rad_per_frame"])
                f[y0:y0 + rh, x0:x0 + rw] = r
            if wave:
                f += wave["amp"] * torch.sin(xx / wave["px"]
                                             + i * wave["rad_per_frame"])
            if grain:
                f += torch.randint(-grain, grain + 1, (height, width),
                                   generator=gen, device=dev).float()
            fy[j] = f
        ii = torch.tensor(list(idx), device=dev,
                          dtype=torch.float32)[:, None, None]
        fu = 128 + ch["amp"] * torch.sin((cx + ch["u_shift"] * ii)
                                         / ch["u_px"])
        fv = 128 + ch["amp"] * torch.cos((cy + ch["v_shift"] * ii)
                                         / ch["v_px"])
        fu = fu.expand(len(idx), height // 2, width // 2)
        fv = fv.expand(len(idx), height // 2, width // 2)
        y, u, v = (p.clamp(0, 255).to(torch.uint8).cpu().numpy()
                   for p in (fy, fu, fv))
        frames += [[y[j], u[j], v[j]] for j in range(len(idx))]
    return frames
