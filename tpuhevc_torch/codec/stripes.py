"""Row stripes of the grid step, and what passes between them.

The grid step (`GridStep.frame_steps`) codes the rows [y0, y1) of a P
picture as a generator: where it needs rows or fields that other stripes
hold, it yields a request and goes on with the answer. `Exchange.run`
drives the stripes' generators in lockstep, each with its device
current, and answers every request across the stripes:

- `Halo(items)`: per item (x, above, below, dim, edge, dtype), the
  stripe's own rows of a picture field x (along `dim`) with `above` rows
  before them and `below` after, taken from the stripes that hold them,
  as many stripes up or down as the reach spans (views of the stripe's
  own rows, copies of the others'). edge "repeat": rows past the
  picture's edges repeat its edge row, as the whole picture's clamped
  reads do; "cut": they are left out, and a halo with no rows to add
  returns x itself. Rows are copied as `dtype` where it is given (8-bit
  samples as uint8);
- `Gather(xs)`: every stripe's rows of the fields xs, in stripe order
  (per-block fields of a few ints a block);
- `Once(fn, xs)`: the first stripe's fn, called once on the first device
  with every stripe's xs -> one answer per stripe, each sent to its
  stripe's device.

A whole picture is one stripe: its halos repeat or cut its own edge
rows, and its gathers and `Once` see only its own fields. `Exchange`
counts the bytes that cross between stripes: the halo rows, an edge
row that repeats once (`halo_bytes`), and the gathered fields and
`Once`'s inputs and answers (`field_bytes`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import on_device


@dataclass(frozen=True)
class Rows:
    """The luma rows [y0, y1) of an H-row picture that one stripe codes."""

    y0: int
    y1: int
    H: int

    def above(self, k: int) -> int:
        """The rows of a k-row "cut" luma halo above the stripe: those
        inside the picture."""
        return min(k, self.y0)

    def below(self, k: int) -> int:
        """The rows of a k-row "cut" luma halo below the stripe."""
        return min(k, self.H - self.y1)


@dataclass
class HaloItem:
    x: torch.Tensor
    above: int
    below: int
    dim: int = 0
    edge: str = "repeat"
    dtype: torch.dtype | None = None


@dataclass
class Halo:
    items: list


@dataclass
class Gather:
    xs: list


@dataclass
class Once:
    fn: object
    xs: list


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    return x


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.nbytes
    if isinstance(x, (tuple, list)):
        return sum(_nbytes(v) for v in x)
    return 0


class Exchange:
    """Drives the generators of the stripes on `devices` (stripe k on
    devices[k]) in lockstep, and counts the bytes between stripes."""

    def __init__(self, devices):
        self.devices = tuple(devices)
        self.halo_bytes = 0
        self.field_bytes = 0

    def run(self, gens) -> list:
        """-> the generators' return values, in stripe order."""
        if len(gens) != len(self.devices):
            raise ValueError(f"{len(gens)} stripes on {len(self.devices)} "
                             "devices")
        answers = [None] * len(gens)
        while True:
            reqs, done = [], []
            for g, dev, a in zip(gens, self.devices, answers):
                with on_device(dev):
                    try:
                        reqs.append(g.send(a))
                    except StopIteration as stop:
                        done.append(stop.value)
            if len(done) == len(gens):
                return done
            if done or len({type(r) for r in reqs}) != 1:
                raise RuntimeError("the stripes' frame steps are out of step: "
                                   f"{[type(r).__name__ for r in reqs]}, "
                                   f"{len(done)} done")
            answers = getattr(self, "_" + type(reqs[0]).__name__.lower())(
                reqs)

    def _halo(self, reqs) -> list:
        out = [[] for _ in reqs]
        for j in range(len(reqs[0].items)):
            items = [r.items[j] for r in reqs]
            dim = items[0].dim
            sizes = [it.x.shape[dim] for it in items]
            starts = [sum(sizes[:i]) for i in range(len(sizes))]
            for i, it in enumerate(items):
                a, b = starts[i], starts[i] + sizes[i]
                up = self._span(items, starts, a - it.above, a, i)
                dn = self._span(items, starts, b, b + it.below, i)
                out[i].append(torch.cat(up + [it.x] + dn, dim) if up or dn
                              else it.x)
        return out

    def _span(self, items, starts, r0, r1, i) -> list:
        """The picture rows [r0, r1) of the items' field as pieces on
        stripe i's device: one narrow view a stripe, and each run of rows
        past the picture's edges ("repeat") its edge row expanded."""
        dim = items[i].dim
        spans = [(k, s, s + it.x.shape[dim])
                 for k, (it, s) in enumerate(zip(items, starts))]
        total = spans[-1][2]
        lo, hi = max(r0, 0), min(r1, total)
        pieces = []
        for k, s, e in spans:
            if items[i].edge == "repeat" and r0 < 0 and s <= 0 < e:
                pieces.append(self._piece(items, k, 0, 1, i, min(r1, 0) - r0))
        for k, s, e in spans:
            if max(lo, s) < min(hi, e):
                pieces.append(self._piece(items, k, max(lo, s) - s,
                                          min(hi, e) - s, i))
        for k, s, e in spans:
            if items[i].edge == "repeat" and r1 > total and s < total <= e:
                pieces.append(self._piece(items, k, total - 1 - s, total - s,
                                          i, r1 - max(r0, total)))
        return pieces

    def _piece(self, items, k, r0, r1, i, repeat=0):
        """Rows [r0, r1) of stripe k's field (a view), copied to stripe
        i's device if k is another stripe; repeat: the one row expanded to
        that many."""
        it = items[i]
        src = items[k].x
        p = src.narrow(it.dim, r0, r1 - r0)
        if k != i:
            if it.dtype is not None:
                p = p.to(it.dtype)
            self.halo_bytes += p.nbytes
            p = p.to(self.devices[i]).to(src.dtype)
        if repeat:
            p = p.expand(*[repeat if d == it.dim else -1
                           for d in range(p.dim())])
        return p

    def _gather(self, reqs) -> list:
        out = []
        for i, dev in enumerate(self.devices):
            fields = []
            for k in range(len(reqs[0].xs)):
                parts = [r.xs[k] for r in reqs]
                self.field_bytes += sum(p.nbytes for j, p in enumerate(parts)
                                        if j != i)
                fields.append(torch.cat([p.to(dev) for p in parts])
                              if len(parts) > 1 else parts[0])
            out.append(fields)
        return out

    def _once(self, reqs) -> list:
        dev0 = self.devices[0]
        self.field_bytes += sum(_nbytes(r.xs) for r in reqs[1:])
        with on_device(dev0):
            answers = reqs[0].fn([_to(r.xs, dev0) for r in reqs])
        self.field_bytes += sum(_nbytes(a) for a in answers[1:])
        return [_to(a, dev) for a, dev in zip(answers, self.devices)]


def run_one(gen, device):
    """Run one stripe (a whole picture) alone: its return value."""
    return Exchange([device]).run([gen])[0]
