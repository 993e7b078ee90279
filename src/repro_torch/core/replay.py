"""Experience replay ring buffer (port of `repro.core.replay`, paper §4.3).

A fixed-capacity ring of (s, a, r, s2, done) transitions per agent, with a
leading agent axis B.  Sampling is uniform over the filled part; the TD loss
masks the whole batch while the buffer is empty.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng


@dataclasses.dataclass
class ReplayBuffer:
    s: torch.Tensor        # (B, cap, state_dim) f32
    a: torch.Tensor        # (B, cap) i32
    r: torch.Tensor        # (B, cap) f32
    s2: torch.Tensor       # (B, cap, state_dim) f32
    done: torch.Tensor     # (B, cap) f32
    ptr: torch.Tensor      # (B,) i32
    size: torch.Tensor     # (B,) i32


def init_replay(capacity: int, state_dim: int, batch: int,
                device: torch.device) -> ReplayBuffer:
    z = lambda *s, dt=torch.float32: torch.zeros((batch,) + s, dtype=dt,
                                                 device=device)
    return ReplayBuffer(s=z(capacity, state_dim), a=z(capacity, dt=torch.int32),
                        r=z(capacity), s2=z(capacity, state_dim),
                        done=z(capacity), ptr=z(dt=torch.int32),
                        size=z(dt=torch.int32))


def push(buf: ReplayBuffer, s, a, r, s2, done,
         mask: torch.Tensor | None = None) -> ReplayBuffer:
    """Append one transition per agent.  Agents whose `mask` is False keep
    their buffer unchanged (the masked form of the engine's per-lane select,
    without copying the whole ring)."""
    B, cap = buf.a.shape
    dev = buf.a.device
    if mask is None:
        mask = torch.ones((B,), dtype=torch.bool, device=dev)
    rows = torch.arange(B, device=dev)
    i = buf.ptr.long()

    def put(arr, val):
        out = arr.clone()
        m = mask.reshape((-1,) + (1,) * (val.dim() - 1))
        out[rows, i] = torch.where(m, val.to(arr.dtype), arr[rows, i])
        return out

    done = torch.as_tensor(done, dtype=torch.float32, device=dev).expand(B)
    return ReplayBuffer(
        s=put(buf.s, s), a=put(buf.a, a), r=put(buf.r, r), s2=put(buf.s2, s2),
        done=put(buf.done, done),
        ptr=torch.where(mask, (buf.ptr + 1) % cap, buf.ptr),
        size=torch.where(mask, torch.clamp(buf.size + 1, max=cap), buf.size))


def sample(buf: ReplayBuffer, key: torch.Tensor, batch_size: int) -> dict:
    """Uniform sample of `batch_size` rows per agent with validity weights;
    safe when the buffer is empty.  Indices are the reference's
    `jax.random.randint(key, (batch_size,), 0, max(size, 1))`, one key
    (B, 2) per agent, drawn on the device (no host sync)."""
    B = buf.a.shape[0]
    dev = buf.a.device
    hi = torch.clamp(buf.size, min=1)
    idx = prng.randint(key, (batch_size,), 0, hi).long()
    w = torch.where(buf.size[:, None] > 0,
                    torch.ones((B, batch_size), device=dev),
                    torch.zeros((B, batch_size), device=dev))
    take = lambda x: x.gather(1, idx) if x.dim() == 2 else x.gather(
        1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    return {"s": take(buf.s), "a": take(buf.a), "r": take(buf.r),
            "s2": take(buf.s2), "done": take(buf.done), "w": w}
