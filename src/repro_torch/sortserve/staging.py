"""Persistent transfer buffers of the machine backends.

A machine tile (the colskip kernel's, or the mesh kernel's) crosses to the
card and back through the :class:`Staging` of the backend that runs it:
one or more input slots, each a pinned host slab and a device buffer for
the tile's (B, N) words, and one output set, a device slab the kernel
writes and a pinned host slab it is copied into, both int32 words laid
out by :func:`out_layout`.  Every buffer grows to the largest tile seen
(its capacity a power of two words) and never shrinks; a tile's views are
carved from the buffers by its own shape and kept per signature.  So a
warm tile costs one copy in, one launch, one copy out and one wait, and
allocates nothing.

On a CPU device the same buffers are plain host tensors (nothing is
pinned, no stream or event is used) and the backends run the plain
machines through them on the same path; no tile crosses to a card there,
so :meth:`Staging.report` counts none as staged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["OUTPUTS", "Staging", "out_layout", "split"]

# a machine tile's outputs, in slab order; "rounds" only on the mesh kernel
OUTPUTS = ("values", "order", "column_reads", "cycles", "rounds")


def out_layout(b: int, stop: int, mesh: bool = False) -> dict[str, slice]:
    """Word ranges of a (B, N) machine tile's outputs in an output slab,
    back to back: values and order (B x stop words each), then the column
    reads, cycles and, for the mesh kernel, rounds (B words each)."""
    sizes = (b * stop, b * stop, b, b, b)
    out, at = {}, 0
    for name, size in zip(OUTPUTS[:5 if mesh else 4], sizes):
        out[name] = slice(at, at + size)
        at += size
    return out


def _capacity(words: int) -> int:
    """Words a buffer is grown to for ``words``: the next power of two."""
    return 1 << max(0, words - 1).bit_length()


@dataclass
class _Input:
    """One signature's views of an input slot."""
    host: np.ndarray            # (B, N) uint32 view of the pinned slab
    pinned: torch.Tensor        # the same words as a tensor
    x: torch.Tensor             # (B, N) int32 view of the device buffer


@dataclass
class _Output:
    """One signature's views of the output set."""
    layout: dict                # out_layout(B, stop, mesh)
    outs: tuple                 # the kernel's outputs, views of the slab
    dev: torch.Tensor           # the slab's used words on the device
    pinned: torch.Tensor        # the same words in the pinned host slab
    host: np.ndarray            # and as an int32 array


class Staging:
    """The transfer buffers of one machine backend instance on ``device``.

    ``slots`` input slots: slot 0 serves a tile's own copy in
    (:meth:`put`), further slots the copies a backend stages ahead on a
    side stream (:meth:`put_ahead`).  :attr:`grows` counts the buffers
    (re)allocated, the first allocation included, since
    :meth:`drain_grows` last read it.  The instance is not locked: each
    engine builds its own backends and calls them under its own lock."""

    def __init__(self, device, slots: int = 1):
        self.device = torch.device(device)
        self.grows = 0
        self._card = self.device.type == "cuda"
        self._in: list = [None] * slots      # slot -> (pinned, device)
        self._out = None                     # (pinned, device)
        self._inputs: dict = {}              # (slot, B, N) -> _Input
        self._outputs: dict = {}             # (B, stop, mesh) -> _Output
        self._done = torch.cuda.Event() if self._card else None
        self._ahead: list = [None] * slots   # slot -> its copy's event
        self._side = None                    # the side stream

    def _fit(self, pair, words: int):
        """``pair`` if it holds ``words`` words, else a new pair of
        buffers: (host, device) words of a power-of-two capacity."""
        if pair is not None and pair[0].numel() >= words:
            return pair
        if pair is not None and self._card:
            # a copy or a kernel still in flight may use the old buffers
            torch.cuda.synchronize(self.device)
        cap = _capacity(words)
        self.grows += 1
        return (torch.empty(cap, dtype=torch.int32, pin_memory=self._card),
                torch.empty(cap, dtype=torch.int32, device=self.device))

    def input(self, b: int, n: int, slot: int = 0) -> _Input:
        """Views of input ``slot`` for a (B, N) tile, growing it if it is
        too small."""
        key = (slot, b, n)
        view = self._inputs.get(key)
        if view is not None:
            return view
        pair = self._fit(self._in[slot], b * n)
        if pair is not self._in[slot]:
            self._in[slot] = pair
            self._inputs = {k: v for k, v in self._inputs.items()
                            if k[0] != slot}
        pinned, dev = pair
        pinned = pinned[:b * n].view(b, n)
        view = _Input(pinned.numpy().view(np.uint32), pinned,
                      dev[:b * n].view(b, n))
        self._inputs[key] = view
        return view

    def output(self, b: int, stop: int, mesh: bool = False) -> _Output:
        """Views of the output set for a tile of B rows and ``stop``
        outputs a row, growing it if it is too small."""
        key = (b, stop, mesh)
        view = self._outputs.get(key)
        if view is not None:
            return view
        layout = out_layout(b, stop, mesh)
        words = max(s.stop for s in layout.values())
        pair = self._fit(self._out, words)
        if pair is not self._out:
            self._out = pair
            self._outputs = {}
        dev, pinned = pair[1], pair[0]
        shapes = {"values": (b, stop), "order": (b, stop)}
        outs = tuple(dev[s].view(shapes.get(name, (b,)))
                     for name, s in layout.items())
        view = _Output(layout, outs, dev[:words], pinned[:words],
                       pinned[:words].numpy())
        self._outputs[key] = view
        return view

    def put(self, data: np.ndarray, view: _Input) -> torch.Tensor:
        """Copy a tile's words into the pinned slab and enqueue their copy
        to the device on the current stream; returns the device view."""
        np.copyto(view.host, data, casting="unsafe")
        view.x.copy_(view.pinned, non_blocking=True)
        return view.x

    def put_ahead(self, data: np.ndarray, slot: int) -> _Input:
        """:meth:`put` into input ``slot`` on a side stream, so the copy runs
        while the card is busy with an earlier tile; :meth:`ready` orders
        the current stream after it.  Returns the slot's views, which the
        caller keeps for :meth:`ready`: a later :meth:`input` may grow the
        slot and so replace its buffers, and the views keep the ones that
        hold this tile.  The slot's last tile has run to its end
        (:meth:`take` waits for it) before a later one is staged there.  On
        the CPU the copy is made at once."""
        b, n = data.shape
        view = self.input(b, n, slot)
        if not self._card:
            self.put(data, view)
            return view
        done = self._ahead[slot]
        if done is None:
            done = self._ahead[slot] = torch.cuda.Event()
        else:
            done.synchronize()           # the slot's last copy has read it
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        np.copyto(view.host, data, casting="unsafe")
        with torch.cuda.stream(self._side):
            view.x.copy_(view.pinned, non_blocking=True)
            done.record(self._side)
        return view

    def ready(self, view: _Input, slot: int) -> torch.Tensor:
        """The device words of a tile staged ahead in ``slot``
        (:meth:`put_ahead`'s ``view``), with the current stream ordered
        after their copy."""
        if self._card:
            torch.cuda.current_stream(self.device).wait_event(
                self._ahead[slot])
        return view.x

    def take(self, view: _Output) -> np.ndarray:
        """Enqueue the copy of the tile's output words to the pinned slab,
        wait for it, and return them in an array of their own: the slab is
        the next tile's, and a result outlives it (the scheduler's sink,
        the result cache and the fault injector hold or change it)."""
        view.pinned.copy_(view.dev, non_blocking=True)
        if self._done is not None:
            self._done.record(torch.cuda.current_stream(self.device))
            self._done.synchronize()
        return view.host.copy()

    def drain_grows(self) -> int:
        """Grows since the last call (a tile's report)."""
        grows, self.grows = self.grows, 0
        return grows

    def report(self) -> dict:
        """A tile's meta: ``staged``, whether it crossed to the card on
        these buffers, and ``staging_grows``, the buffers grown since the
        last report; False and 0 on the CPU, where nothing crosses."""
        grows = self.drain_grows()
        return {"staged": self._card,
                "staging_grows": grows if self._card else 0}


def split(words: np.ndarray, view: _Output) -> dict[str, np.ndarray]:
    """A tile's outputs from its words (:meth:`Staging.take`): values
    (B, stop) uint32 and order (B, stop) int32, views of ``words``; column
    reads, cycles and rounds (B,) int64."""
    lay = view.layout
    b, stop = view.outs[0].shape
    out = {"values": words[lay["values"]].view(np.uint32).reshape(b, stop),
           "order": words[lay["order"]].reshape(b, stop)}
    for name in OUTPUTS[2:]:
        if name in lay:
            out[name] = words[lay[name]].astype(np.int64)
    return out
