"""The palette layout of a pipeline's states: which table each stream
reads, and whether the state is marked for the blockwise colormap or sorted
by palette.

`StreamState.tables` holds the layout in the JAX package's tuple format:

  * ``(t,)``: per-row [S, R*4] or uniform [1, R*4] built-in tables;
  * ``(t, marker)``: the same, marked for the blockwise colormap (the
    marker is a zero-size 1-D int32 tensor; real tables are 2-D);
  * ``(t_sorted, perm, inv)``: sorted within the sort blocks of
    `stream_blocks`, perm and inv relative to their block;
  * ``(t_sorted, perm, inv, marker)``: sorted with global perm and inv (the
    whole-state sort, or the per-shard sort of `parallel.mesh`, whose
    rank-local slices hold perm and inv less their slice's offset);
  * ``(u, v)``: a generic registry's factor tables;
  * ``()``: a static palette.

sorted[i] = external[perm[i]] and external[e] = sorted[inv[e]].  A
`PaletteLayout` (a pipeline's `palette_layout`) is the one reader of that
format (`read`, `local`, `check`) and the one owner of what it means: the
policy that lays out concrete ids (`tables_for`), the permutations as
global stream indices (`global_perms`) and the carry's stream order in
carry-sort mode (`carry_to_external`, `carry_from_external`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from spectrogram_tpu_torch.ops.cuda import colormap_kernel


def _is_marker(t) -> bool:
    return t.ndim == 1 and t.shape[0] == 0


def _is_index(t) -> bool:
    return t.ndim == 1 and t.shape[0] > 0


class Tables(NamedTuple):
    """What a tables tuple says: `colormap` the 2-D tables the colormap
    reads; `perm` and `inv` a sorted tuple's permutations (None unsorted),
    global stream indices where `perm_global` (the length-4 form), else
    relative to their sort block; `marked` a trailing blockwise marker."""

    colormap: tuple
    perm: Optional[torch.Tensor]
    inv: Optional[torch.Tensor]
    perm_global: bool
    marked: bool

    @property
    def sorted(self) -> bool:
        return self.perm is not None


class PaletteLayout:
    """A pipeline's palette-layout settings and decisions.  `tables_for`
    counts each decision under the pipeline's "layout.*" `counters`, and
    `last_layout` keeps the last order the blockwise test read."""

    # Engage the blockwise colormap where at least this fraction of the
    # colormap's row blocks are single-palette (the JAX package's value).
    BW_AUTO_FRAC = 0.5
    # stream_blocks="auto": sort blocks of this many streams from this many
    # streams up, in the k=1 streaming mode without a ring (the JAX
    # package's stream-blocked push)
    STREAM_BLOCK_AUTO_MIN = 12288
    STREAM_BLOCK_SIZE = 4096

    def __init__(self, pipeline, resample: np.ndarray):
        """The layout of `pipeline`'s states, from its settings; `resample`
        is its [H, W] resample matrix, whose bin band sizes the JAX
        colormap's row blocks (its banded plan, or the whole matrix where
        banding does not pay)."""
        p = pipeline
        if p.static_table is not None:
            self.registry = ()
        elif p.builtin_tables is not None:
            self.registry = (p.builtin_tables,)
        else:
            self.registry = p.generic_tables
        self.n_palettes = len(p.schemes)
        self.chunk_hops = p.chunk_hops
        self.store_ring = p.store_ring
        self.stream_blocks = p.stream_blocks
        self.palette_sort = p.palette_sort
        self.blockwise_palettes = p.blockwise_palettes
        self.carry_sort_mode = p.carry_sort_mode
        self.device = p.device
        self.counters = p.counters
        self.last_layout = None
        segs = colormap_kernel.band_segments(resample.T)
        self._band = (max(hi - lo for _, _, lo, hi in segs)
                      if colormap_kernel._banded_worthwhile(segs, *resample.T.shape)
                      else resample.shape[1])

    # ------------------------------------------------------------- format

    @staticmethod
    def read(tables: tuple) -> Tables:
        """The record of a tables tuple (of tensors or numpy arrays)."""
        n = len(tables)
        marked = bool(n) and _is_marker(tables[-1])
        if (n in (3, 4) and _is_index(tables[1]) and _is_index(tables[2])
                and (n == 3 or marked)):
            return Tables(tables[:1], tables[1], tables[2], n == 4, marked)
        return Tables(tuple(t for t in tables if t.ndim == 2), None, None, False, marked)

    @staticmethod
    def check(tables: tuple) -> None:
        """Raise ValueError unless `tables` (tensors or numpy arrays) is one
        of the forms a pipeline pushes."""
        v = PaletteLayout.read(tables)
        two_d = [t.ndim == 2 for t in tables]
        ok = not tables or (two_d[0] and (
            v.sorted or len(tables) == 1 + v.marked
            or (len(tables) == 2 and all(two_d) and tables[0].shape == tables[1].shape)))
        if not ok:
            raise ValueError(
                "expected () (static_palette), ([S|1, R*4],), with a blockwise "
                "marker, a generic (u, v) pair of same-shape [S|1, R*4] tables, or "
                "a palette-sorted (t_sorted, perm, inv[, marker]) tuple; got "
                f"shapes {[tuple(t.shape) for t in tables]}"
            )

    @staticmethod
    def local(tables: tuple, lo: int, hi: int, device) -> tuple:
        """Streams [lo, hi) of a whole state's tables, on `device`:
        per-stream tables sliced, uniform tables and the marker as they are,
        a per-shard sorted tuple's perm and inv made rank-local."""
        if PaletteLayout.read(tables).sorted:
            t, perm, inv, marker = tables
            return (t[lo:hi].contiguous().to(device), (perm[lo:hi] - lo).to(device),
                    (inv[lo:hi] - lo).to(device), marker.to(device))
        return tuple(t.to(device) if t.ndim == 1 or t.shape[0] == 1
                     else t[lo:hi].contiguous().to(device) for t in tables)

    def _marker(self) -> torch.Tensor:
        """The zero-size 1-D int32 tensor that marks a state for the
        blockwise colormap."""
        return torch.zeros((0,), dtype=torch.int32, device=self.device)

    # ----------------------------------------------------------- registry

    def check_ids(self, ids: np.ndarray) -> None:
        if ids.size and (ids.min() < 0 or ids.max() >= self.n_palettes):
            raise ValueError(f"palette_id out of range 0..{self.n_palettes - 1}: {ids!r}")

    def tables_of(self, palette_id: torch.Tensor) -> tuple:
        """The registry's tables for [S] (or [1]) palette ids: () for a
        static palette, ([S, R*4],) built-in, (u, v) generic."""
        idx = palette_id.to(torch.int64)
        return tuple(t.index_select(0, idx).contiguous() for t in self.registry)

    def one_palette(self, palette_id: torch.Tensor) -> tuple:
        """`tables_of` [S] ids that all name one palette: under
        blockwise_palettes="auto" built-in tables are marked (every block
        is uniform)."""
        tables = self.tables_of(palette_id)
        if self.blockwise_palettes == "auto" and len(tables) == 1 and palette_id.numel():
            tables += (self._marker(),)
        return tables

    def _index(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)

    # ------------------------------------------------------------- policy

    def block_rows(self, n_rows: int) -> int:
        """The JAX colormap's row-block size for n_rows rows (its
        `_auto_blocks` over the band, with the n % block fallback): the
        unit in which palette uniformity is counted, and the rows a
        blockwise CTA covers."""
        block_rows, _ = colormap_kernel._auto_blocks(self._band, None, None)
        return min(block_rows, n_rows) if n_rows % block_rows else block_rows

    def sort_block_streams(self, s: int) -> int:
        """Sort-block size for S streams (0 = one block)."""
        sb = self.stream_blocks
        if sb == "auto":
            if (self.chunk_hops == 1 and not self.store_ring
                    and s >= self.STREAM_BLOCK_AUTO_MIN):
                return self.STREAM_BLOCK_SIZE
            return 0
        return sb if 0 < sb < s else 0

    def blockwise(self, tables: tuple) -> bool:
        """Whether a state's pushes take the blockwise colormap: forced on,
        palette-sorted (the sort exists to feed it), or marked."""
        v = self.read(tables)
        return (self.blockwise_palettes is True or v.sorted
                or (self.blockwise_palettes == "auto" and v.marked))

    def tables_for(self, ids, shards: Optional[int] = None) -> tuple:
        """The tables of [S] concrete palette ids in their layout: the
        blockwise marker where the layout is already clustered ("auto"),
        else the palette sort where it passes the blockwise test, else
        per-row tables.  Unsharded (`shards` None) the sort is the block
        sort, then the whole-state sort; over `shards` ranks it is the
        per-shard sort, which one rank declines, as the JAX package's
        shard_state does.  A generic (u, v) pair is neither marked nor
        sorted."""
        ids = np.asarray(ids, np.int32).reshape(-1)
        self.check_ids(ids)
        tables = self.tables_of(self._index(ids))
        if len(tables) != 1:
            self.counters["layout.generic" if tables else "layout.unsorted"] += 1
            return tables
        if self._uniform(ids):
            self.counters["layout.clustered"] += 1
            return tables + (self._marker(),) if self.blockwise_palettes == "auto" else tables
        sorted_tables = self._sorted(tables, ids, shards) if self.palette_sort else None
        if sorted_tables is None:
            self.counters["layout.unsorted"] += 1
            return tables
        return sorted_tables

    def _uniform(self, ids: np.ndarray) -> bool:
        """The blockwise test: True when >= BW_AUTO_FRAC of the row blocks
        of this per-stream palette order are single-palette."""
        s = int(ids.shape[0])
        ts = self.block_rows(s * self.chunk_hops)
        nb = s // ts
        self.counters["layout.tests"] += 1
        if nb == 0:
            self.last_layout = {"blocks": 0, "uniform": 0}
            return bool(ids.size) and bool((ids == ids.flat[0]).all())
        head = ids[: nb * ts].reshape(nb, ts)
        uniform = (head == head[:, :1]).all(axis=1)
        self.last_layout = {"blocks": nb, "uniform": int(uniform.sum())}
        return float(uniform.mean()) >= self.BW_AUTO_FRAC

    def _sorted(self, tables: tuple, ids: np.ndarray, shards: Optional[int]):
        """The sorted tuple the blockwise test passes, or None.  Unsharded:
        a stable argsort within each sort block, (t_sorted, perm, inv) with
        block-relative perm and inv; where that fails, in carry-sort mode
        with more than one block, one whole-state sort.  Over `shards`
        ranks: one sort per shard slice, in carry-sort mode."""
        s = int(ids.shape[0])
        views = self.carry_sort_mode and self.blockwise_palettes in ("auto", True)
        if shards is not None:
            ok = views and shards > 1 and not s % shards
            return self._view_sorted(tables, ids, s // shards) if ok else None
        bs = self.sort_block_streams(s) or s
        perm, inv = self._argsort(ids, bs)
        if not self._uniform(ids[perm]):
            return self._view_sorted(tables, ids, s) if views and bs < s else None
        self.counters["layout.sorted_blocks"] += 1
        off = np.arange(s, dtype=np.int32) // bs * bs
        return (tables[0].index_select(0, self._index(perm)),
                self._index(perm - off), self._index(inv - off))

    def _view_sorted(self, tables: tuple, ids: np.ndarray, view_bs: int):
        """The length-4 sorted tuple with view blocks of `view_bs` streams
        (the JAX pipeline's `_view_sorted_tables`); None where it fails the
        blockwise test."""
        perm, inv = self._argsort(ids, view_bs)
        if not self._uniform(ids[perm]):
            return None
        self.counters["layout.sorted_global"] += 1
        return (tables[0].index_select(0, self._index(perm)),
                self._index(perm), self._index(inv), self._marker())

    @staticmethod
    def _argsort(ids: np.ndarray, bs: int):
        """One stable argsort per block of `bs` streams: (perm, inv) as
        global stream indices confined to their block."""
        s = int(ids.shape[0])
        perm = np.empty(s, np.int32)
        inv = np.empty(s, np.int32)
        for b0 in range(0, s, bs):
            b1 = min(b0 + bs, s)
            p = b0 + np.argsort(ids[b0:b1], kind="stable").astype(np.int32)
            perm[b0:b1] = p
            inv[p] = np.arange(b0, b1, dtype=np.int32)
        return perm, inv

    # -------------------------------------------------------- stream order

    def global_perms(self, tables: tuple):
        """(perm, inv) of a sorted tables tuple as global stream indices,
        or None when unsorted: a block-relative pair gets its blocks'
        offsets, a global one stays as it is."""
        v = self.read(tables)
        if v.perm is None:
            return None
        s = v.perm.shape[0]
        bs = self.sort_block_streams(s) or s
        if v.perm_global or bs >= s:
            return v.perm, v.inv

        def offset(p: torch.Tensor) -> torch.Tensor:
            return torch.arange(s, dtype=torch.int32, device=p.device) // bs * bs + p

        return offset(v.perm), offset(v.inv)

    def carry_to_external(self, carry: torch.Tensor, tables: tuple) -> torch.Tensor:
        """A carry at rest in the stream order of `tables`, in external
        order: in carry-sort mode a sorted state's carry is sorted; else
        the carry as it is."""
        perms = self.global_perms(tables) if self.carry_sort_mode else None
        return carry if perms is None else carry.index_select(0, perms[1])

    def carry_from_external(self, carry: torch.Tensor, tables: tuple) -> torch.Tensor:
        """An external-order carry in the stream order of `tables` (the
        inverse of `carry_to_external`)."""
        perms = self.global_perms(tables) if self.carry_sort_mode else None
        return carry if perms is None else carry.index_select(0, perms[0])
