"""Row-resident tables on a device mesh.

The counterpart of the JAX package's ``NamedSharding`` row placement
(``caps_tpu/backends/tpu/table.py place_rows`` / ``place_column``): on a
mesh, a column whose row count divides by the shard count is split into
one block of rows per mesh slot, rows flattened DCN-major, block ``i``
on slot ``i``'s device.  A table whose columns are so placed is a
:class:`ShardedTable`: one ordinary :class:`DeviceTable` per slot, each
on a :class:`ShardView` of the session's backend — the slot's device,
and everything else (string pool, size stream, counters, config) the
session backend's own.  So the expression compilers and every
single-program operator run unchanged on a shard's block.

The logical row order of a row-resident table is slot 0's live rows,
then slot 1's, and so on: a placed table's blocks hold consecutive row
ranges, and the row-local operators (``select`` … ``pack_list``) run
per shard and keep each shard's rows in order.  Operators GSPMD would
partition by hand are hand-scheduled here (the distributed joins, the
sharded dense group-by, the sharded count chains); every other operator
first gathers the shards to the lead device in slot order — the
all_gather GSPMD inserts before a sort or a probe — and runs as on one
card.  Each gather is counted under ``collectives.all_gather`` and in
the backend's ``ici_bytes``.

Side columns hold rows by index (a list of lists' inner lists, the lists
and maps "any" values hold: ``Column.child`` / ``Column.maps``); every
block can point into them, so they stay whole and are carried once to
each distinct shard device (on one card the same tensors).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from caps_tpu_torch.backends.cuda.column import Column
from caps_tpu_torch.relational.table import Table


class ShardView:
    """One mesh slot's view of a session backend: its own ``device`` and
    ``slot``; every other attribute read from, and written to, the
    session backend (the size stream, the string pool, the counters).
    A shard runs one program: a view has no mesh."""

    mesh = None
    n_shards = 1

    def __init__(self, base, slot, shards: int):
        object.__setattr__(self, "_base", base)
        object.__setattr__(self, "slot", slot)
        object.__setattr__(self, "device", slot.device)
        object.__setattr__(self, "_shards", shards)
        object.__setattr__(self, "_copies", {})

    def __getattr__(self, name):
        return getattr(self._base, name)

    def __setattr__(self, name, value):
        setattr(self._base, name, value)

    @property
    def base(self):
        return self._base

    def bucket(self, n: int) -> int:
        """A shard's capacity for ``n`` rows: the session's bucket for
        the rows of every shard, over the shard count (so a placed
        block and a block a shard's operator makes share a lattice)."""
        k = self._shards
        return max(1, -(-self._base.bucket(int(n) * k) // k))

    def place_column(self, col: Column) -> Column:
        """A shard's new column is its block already."""
        return col

    def _local(self, key: str, t: torch.Tensor) -> torch.Tensor:
        if t.device == self.device:
            return t
        hit = self._copies.get(key)
        if hit is None or hit[0] is not t:
            hit = (t, t.to(self.device))
            self._copies[key] = hit
        return hit[1]

    def rank_tensor(self) -> torch.Tensor:
        return self._local("rank", self._base.rank_tensor())

    def tombstone_tensor(self, values, dtype: torch.dtype) -> torch.Tensor:
        return self._local(f"tomb{id(values)}{dtype}",
                           self._base.tombstone_tensor(values, dtype))


def shard_views(backend) -> List[ShardView]:
    """The session backend's views, one per slot of its current mesh
    (made anew when the mesh changes)."""
    mesh = backend.mesh
    cached = getattr(backend, "_shard_views", None)
    if cached is None or cached[0] is not mesh:
        views = [ShardView(backend, s, mesh.size) for s in mesh.slots]
        backend._shard_views = cached = (mesh, views)
    return cached[1]


def base_backend(backend):
    """The session backend behind a shard view (itself otherwise)."""
    return backend.base if isinstance(backend, ShardView) else backend


# -- placement --------------------------------------------------------------

_ROW_FIELDS = ("data", "valid", "lens", "elem_valid", "tags", "order")


def _carried(side: Optional[Column], device, memo: dict):
    """A side column on ``device``: carried once per distinct device
    (the same object where it lies there already)."""
    if side is None or side.data.device == device:
        return side
    key = (id(side), str(device))
    if key not in memo:
        moved = side.to_device(device)
        moved._origin = getattr(side, "_origin", side)
        memo[key] = moved
    return memo[key]


def _block(col: Column, lo: int, hi: int, device, copy: bool,
           memo: dict) -> Column:
    """Rows ``[lo, hi)`` of ``col`` on ``device``: every per-row tensor
    (a map's key columns too), the host mirror sliced, side columns
    carried whole.  ``copy`` gives the block storage of its own where it
    stays on the column's device (a view would keep the whole tensor
    alive)."""
    def part(t):
        if t is None:
            return None
        b = t[lo:hi]
        if b.device != device:
            return b.to(device)
        return b.clone() if copy else b
    host = None
    if col.host is not None:
        host = (col.host[0][lo:hi], col.host[1][lo:hi])
    kw = {f: part(getattr(col, f)) for f in _ROW_FIELDS}
    fields = None
    if col.fields is not None:
        fields = {k: _block(c, lo, hi, device, copy, memo)
                  for k, c in col.fields.items()}
    return Column(col.kind, kw.pop("data"), kw.pop("valid"), col.ctype,
                  kw.pop("lens"), host=host, fields=fields,
                  child=_carried(col.child, device, memo),
                  maps=_carried(col.maps, device, memo), **kw)


def split_column(col: Column, mesh, copy: bool = True) -> List[Column]:
    """``col``'s rows cut into one block per mesh slot (the row count
    must divide over the slots)."""
    k = mesh.size
    if col.capacity % k:
        raise ValueError(f"{col.capacity} rows do not divide over {k} "
                         f"shards")
    b = col.capacity // k
    memo: dict = {}
    return [_block(col, i * b, (i + 1) * b, d, copy, memo)
            for i, d in enumerate(mesh.shard_devices)]


def place_rows(backend, col: Column):
    """The JAX package's rule: on a mesh, a column whose row count
    divides over the shards becomes its per-slot blocks (a list);
    anything else stays whole (the column itself)."""
    mesh = backend.mesh
    if mesh is None or col.capacity % mesh.size:
        return col
    return split_column(col, mesh)


def assemble(backend, placed: Dict[str, object], n: int,
             live: Optional[torch.Tensor] = None):
    """A table over placed columns (:meth:`DeviceBackend.place_column`'s
    results): row-resident where they were split, whole otherwise.  A
    block's live rows are its share of the whole table's live prefix."""
    from caps_tpu_torch.backends.cuda.table import DeviceTable
    split = [isinstance(v, list) for v in placed.values()]
    if not any(split):
        return DeviceTable(backend, dict(placed), n, live=live)
    if not all(split):
        raise RuntimeError("a table's columns were placed in two layouts")
    views = shard_views(backend)
    b = next(iter(placed.values()))[0].capacity
    parts = []
    for i, view in enumerate(views):
        cols = {c: blocks[i] for c, blocks in placed.items()}
        n_i = min(max(n - i * b, 0), b)
        live_i = None
        if live is not None:
            live_i = (live.to(view.device) - i * b).clamp(0, b).to(
                torch.int32)
        parts.append(DeviceTable(view, cols, n_i, live=live_i))
    return ShardedTable(backend, parts)


def place_table(table):
    """``table`` with every column passed through its backend's
    placement seam (a row-resident table's blocks are placed already; a
    table of another backend is left as it is)."""
    from caps_tpu_torch.backends.cuda.table import DeviceTable
    if not isinstance(table, DeviceTable):
        return table
    be = table.backend
    if not table._cols:
        return table
    placed = {c: be.place_column(col) for c, col in table._cols.items()}
    return assemble(be, placed, table._n, table._live)


def split_table(table, mesh) -> "ShardedTable":
    """A whole table's rows as per-slot blocks for a hand-scheduled
    stage: padded to a shard multiple, split (views where a slot's
    device is the table's), the live prefix shared out as
    :func:`assemble` does.  No placement seam: the blocks are a stage's
    operands, not a placement."""
    from caps_tpu_torch.backends.cuda.table import _pad_column
    k = mesh.size
    cap = -(-max(table.capacity, 1) // k) * k
    cols = {c: split_column(_pad_column(col, cap), mesh, copy=False)
            for c, col in table._cols.items()}
    if not cols:
        raise ValueError("a table with no columns has no rows to split")
    return assemble(table.backend, cols, table._n, table._live)


# -- gathers ----------------------------------------------------------------

def _row_tensors(col: Column) -> List[torch.Tensor]:
    out = [getattr(col, f) for f in _ROW_FIELDS
           if getattr(col, f) is not None]
    for c in (col.fields or {}).values():
        out += _row_tensors(c)
    return out


def _note_gather(backend, parts) -> None:
    """Count one gather to the lead: the per-row buffers of every block
    not on the lead slot (on a virtual mesh, a copy within one card)."""
    _count_gather(backend, [t for p in parts[1:] for c in p._cols.values()
                            for t in _row_tensors(c)])


def _count_gather(backend, moved: List[torch.Tensor]) -> None:
    from caps_tpu_torch.parallel.collectives import note_collective
    nbytes = sum(int(t.numel()) * t.element_size() for t in moved)
    note_collective("all_gather", moved)
    backend.ici_bytes += nbytes
    backend.gather_bytes += nbytes
    backend.gathers += 1


def _scatter_rows(out: Optional[Column], target: torch.Tensor,
                  got: Column, m: int) -> Column:
    """``got``'s rows written to rows ``target`` of ``out`` (made, of
    ``m`` rows and one sink row past them, where None)."""
    def put(o, x):
        if x is None:
            return None
        if o is None:
            o = torch.zeros((m + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                            device=x.device)
        return o.index_copy_(0, target, x)
    kw = {f: put(None if out is None else getattr(out, f), getattr(got, f))
          for f in _ROW_FIELDS}
    fields = None
    if got.fields is not None:
        fields = {k: _scatter_rows(None if out is None else out.fields[k],
                                   target, c, m)
                  for k, c in got.fields.items()}
    return Column(got.kind, kw.pop("data"), kw.pop("valid"), got.ctype,
                  kw.pop("lens"), fields=fields, child=got.child,
                  maps=got.maps, **kw)


def _head(col: Column, m: int) -> Column:
    """``col``'s first ``m`` rows (the sink row of :func:`_scatter_rows`
    dropped)."""
    kw = {f: None if getattr(col, f) is None else getattr(col, f)[:m]
          for f in _ROW_FIELDS}
    fields = None if col.fields is None else {
        k: _head(c, m) for k, c in col.fields.items()}
    return Column(col.kind, kw.pop("data"), kw.pop("valid"), col.ctype,
                  kw.pop("lens"), fields=fields, child=col.child,
                  maps=col.maps, **kw)


def _origin(side):
    return None if side is None else getattr(side, "_origin", side)


def _uniform(cols: Sequence[Column]) -> bool:
    """Blocks of one column that concatenate as they are: one kind, one
    shape and dtype per per-row tensor, the same side columns."""
    a = cols[0]
    for c in cols[1:]:
        if c.kind != a.kind or _origin(c.child) is not _origin(a.child) \
                or _origin(c.maps) is not _origin(a.maps) \
                or (c.fields is None) != (a.fields is None):
            return False
        for f in _ROW_FIELDS:
            x, y = getattr(a, f), getattr(c, f)
            if (x is None) != (y is None):
                return False
            if x is not None and (x.dtype != y.dtype
                                  or x.shape[1:] != y.shape[1:]):
                return False
        if a.fields is not None:
            if list(a.fields) != list(c.fields) or not all(
                    _uniform([a.fields[k], c.fields[k]]) for k in a.fields):
                return False
    return True


def _concat_blocks(cols: Sequence[Column], ns: Sequence[int], cap: int,
                   lead, host: bool = False) -> Column:
    """Uniform blocks' live rows, in slot order, on ``lead`` and padded
    to ``cap`` rows (with ``host``, their ingest mirrors too)."""
    import torch.nn.functional as F
    a = cols[0]
    kw = {}
    for f in _ROW_FIELDS:
        if getattr(a, f) is None:
            kw[f] = None
            continue
        both = torch.cat([getattr(c, f)[:n].to(lead)
                          for c, n in zip(cols, ns)])
        rest = cap - both.shape[0]
        fill = True if f == "elem_valid" else 0
        if f == "valid":
            fill = False
        kw[f] = F.pad(both, (0, 0) * (both.dim() - 1) + (0, rest),
                      value=fill) if rest else both
    fields = None
    if a.fields is not None:
        fields = {k: _concat_blocks([c.fields[k] for c in cols], ns, cap,
                                    lead, host) for k in a.fields}
    ctype = a.ctype
    for c in cols[1:]:
        ctype = ctype.join(c.ctype)
    mirror = None
    if host and all(c.host is not None for c in cols):
        # the blocks' ingest mirrors, as the whole column's
        mirror = tuple(np.concatenate(
            [np.asarray(c.host[j][:n]) for c, n in zip(cols, ns)]
            + [np.zeros(cap - sum(ns), dtype=np.asarray(a.host[j]).dtype)])
            for j in (0, 1))
    memo: dict = {}
    return Column(a.kind, kw.pop("data"), kw.pop("valid"), ctype,
                  kw.pop("lens"), host=mirror, fields=fields,
                  child=_carried(a.child, lead, memo),
                  maps=_carried(a.maps, lead, memo), **kw)


def gather_parts(backend, parts, cols: Optional[Sequence[str]] = None,
                 host: bool = False, lead=None):
    """The blocks' live rows concatenated in slot order on the lead
    device (or ``lead``), as one whole table of the session backend
    (counted as a gather); with ``host``, the columns keep their ingest
    mirrors (a re-shard's, for the CSR it rebuilds)."""
    from caps_tpu_torch.backends.cuda.table import DeviceTable
    lead = backend.device if lead is None else lead
    if cols is not None:
        parts = [p.select(cols) for p in parts]
    _note_gather(backend, parts)
    names = parts[0].columns
    if all(p._live is None for p in parts) and all(
            _uniform([p._cols[c] for p in parts]) for c in names):
        ns = [p._n for p in parts]
        n = sum(ns)
        cap = backend.bucket(n)
        out = {c: _concat_blocks([p._cols[c] for p in parts], ns, cap, lead,
                                 host) for c in names}
        return DeviceTable(backend, out, n)
    # blocks of several kinds, widths or side columns (or served row
    # bounds under generic replay): the UNION's alignment, pairwise
    memo: dict = {}
    whole = []
    for p in parts:
        moved = {c: (col if col.data.device == lead else
                     _to_lead(col, lead, memo))
                 for c, col in p._cols.items()}
        t = DeviceTable(backend, moved, p._n,
                        live=None if p._live is None else p._live.to(lead))
        t._exact_cache = p._exact_cache
        whole.append(t)
    while len(whole) > 1:
        whole = [whole[i].union_all(whole[i + 1])
                 if i + 1 < len(whole) else whole[i]
                 for i in range(0, len(whole), 2)]
    out = whole[0]
    if out._live is not None and all(
            p._live is None or p._exact_cache is not None for p in parts):
        out._exact_cache = sum(p._exact_n() for p in parts)
    return out


def _mirrored(col: Column) -> bool:
    """A column its ingest mirror rebuilds: a mirror, and no per-row
    tensor but ``data`` and ``valid``."""
    return col.host is not None and col.fields is None and all(
        getattr(col, f) is None for f in _ROW_FIELDS[2:])


def _from_mirrors(cols: Sequence[Column], ns: Sequence[int], cap: int,
                  lead) -> Column:
    """One column from its blocks' ingest mirrors (live rows in slot
    order, padded to ``cap``): no device buffer is read."""
    mirror = tuple(np.concatenate(
        [np.asarray(c.host[j][:n]) for c, n in zip(cols, ns)]
        + [np.zeros(cap - sum(ns), dtype=np.asarray(cols[0].host[j]).dtype)])
        for j in (0, 1))
    ctype = cols[0].ctype
    for c in cols[1:]:
        ctype = ctype.join(c.ctype)
    return Column(cols[0].kind, torch.from_numpy(mirror[0]).to(lead),
                  torch.from_numpy(mirror[1]).to(lead), ctype, host=mirror)


def recover(backend, parts, slots, healthy, lead, name: str):
    """A table whole on ``lead`` after a loss of mesh slots (a
    re-shard): rebuilt from its blocks' ingest mirrors where every
    column has one — a lost card's buffers are unreadable and the
    mirror is the replica, as in the JAX package — else gathered from
    its device blocks, which must then all sit on ``healthy`` slots.
    ``parts`` are the table's blocks (a whole table: itself) and
    ``slots`` the slot each lies on.  Raises, naming the table and a
    column without a mirror, where a block on a lost slot is needed."""
    from caps_tpu_torch.backends.cuda.table import DeviceTable
    lost = [s for s in slots if s not in healthy]
    names = parts[0].columns
    if all(_mirrored(p._cols[c]) for p in parts for c in names):
        ns = []
        for p, s in zip(parts, slots):
            if p._live is not None and p._exact_cache is None and \
                    s not in healthy:
                raise RuntimeError(f"re-shard: the live rows of table "
                                   f"{name} on lost slot {s} are unknown")
            ns.append(p._exact_n() if p._live is not None else p._n)
        n = sum(ns)
        cap = backend.bucket(n)
        return DeviceTable(backend, {
            c: _from_mirrors([p._cols[c] for p in parts], ns, cap, lead)
            for c in names}, n)
    if lost:
        bare = next(c for c in names
                    if not all(_mirrored(p._cols[c]) for p in parts))
        raise RuntimeError(
            f"re-shard: table {name} has a block on lost slot {lost[0]} "
            f"and its column {bare!r} has no ingest mirror")
    return gather_parts(backend, parts, host=True, lead=lead)


def _to_lead(col: Column, lead, memo: dict) -> Column:
    def t(x):
        return None if x is None else x.to(lead)
    return Column(col.kind, t(col.data), t(col.valid), col.ctype,
                  t(col.lens), elem_valid=t(col.elem_valid),
                  tags=t(col.tags), order=t(col.order),
                  fields=(None if col.fields is None else
                          {k: _to_lead(c, lead, memo)
                           for k, c in col.fields.items()}),
                  child=_carried(col.child, lead, memo),
                  maps=_carried(col.maps, lead, memo))


def whole(table):
    """``table`` whole on the lead device (a row-resident table
    gathered, counted)."""
    return table.gathered() if isinstance(table, ShardedTable) else table


class ShardedTable(Table):
    """A row-resident table: one :class:`DeviceTable` per mesh slot, on
    the slot's :class:`ShardView` (module docstring)."""

    def __init__(self, backend, parts: Sequence):
        self.backend = base_backend(backend)
        self.parts = list(parts)

    # -- shape ----------------------------------------------------------

    def _map(self, fn) -> "ShardedTable":
        return ShardedTable(self.backend, [fn(p) for p in self.parts])

    @property
    def columns(self) -> Tuple[str, ...]:
        return self.parts[0].columns

    @property
    def size(self) -> int:
        return sum(p._n for p in self.parts)

    @property
    def capacity(self) -> int:
        return sum(p.capacity for p in self.parts)

    @property
    def _live(self):
        lives = [p._live for p in self.parts]
        if all(x is None for x in lives):
            return None
        lead = self.backend.device
        return sum((x.to(lead).to(torch.int64) if x is not None else
                    torch.tensor(p._n, dtype=torch.int64, device=lead))
                   for x, p in zip(lives, self.parts)).to(torch.int32)

    def _exact_n(self) -> int:
        """The exact live row count: the parts' served bounds read in
        one transfer where any is unknown."""
        todo = [p for p in self.parts
                if p._live is not None and p._exact_cache is None]
        if todo:
            lead = self.backend.device
            got = torch.stack([p._live.to(lead).to(torch.int64)
                               for p in todo]).tolist()
            self.backend.syncs += 1
            for p, v in zip(todo, got):
                p._exact_cache = int(v)
        return sum(p._exact_n() for p in self.parts)

    def exact_size(self) -> int:
        return self._exact_n()

    def size_hint(self) -> int:
        return sum(p.size_hint() for p in self.parts)

    def branch_empty(self) -> bool:
        be = self.backend
        mode = be.count_mode
        lives = any(p._live is not None for p in self.parts)
        if lives and (mode is None or mode[0] == "record"):
            host_empty = self._exact_n() == 0
        else:
            host_empty = self.size == 0

        def actual_empty() -> torch.Tensor:
            live = self._live
            if live is not None:
                return live == 0
            return torch.full((), self.size == 0, dtype=torch.bool,
                              device=be.device)
        return be.consume_pred(host_empty, actual_empty)

    def prime_exact(self, viol: torch.Tensor) -> bool:
        """The generic-replay violation flag and every part's exact
        live count in one transfer (``DeviceTable.prime_exact``)."""
        todo = [p for p in self.parts
                if p._live is not None and p._exact_cache is None]
        if not todo:
            return bool(viol)
        lead = self.backend.device
        both = torch.stack([viol.to(lead).to(torch.int64)] + [
            p._live.to(lead).to(torch.int64) for p in todo]).tolist()
        if both[0]:
            return True
        for p, v in zip(todo, both[1:]):
            p._exact_cache = int(v)
        return False

    def column_type(self, col: str):
        return self.parts[0].column_type(col)

    @property
    def nbytes(self) -> int:
        """The bytes the table holds: every block's per-row tensors, and
        each side column once per distinct device that holds it (the
        blocks on one device share it, ``_carried``)."""
        sides: Dict[int, Column] = {}

        def held(col: Column) -> int:
            n = sum(int(t.nbytes) for t in (col.data, col.valid, col.lens,
                                            col.elem_valid, col.tags,
                                            col.order) if t is not None)
            n += sum(held(c) for c in (col.fields or {}).values())
            for side in (col.child, col.maps):
                if side is not None and id(side) not in sides:
                    sides[id(side)] = side
                    n += held(side)
            return n
        return sum(held(c) for p in self.parts for c in p._cols.values())

    def held_tensors(self) -> List[torch.Tensor]:
        """Every tensor of every block (``table.held_tensors``)."""
        from caps_tpu_torch.backends.cuda.table import held_tensors
        return held_tensors(self.parts)

    def stream_mark(self):
        """``table.stream_mark`` over every block's card."""
        from caps_tpu_torch.backends.cuda.table import stream_mark
        return stream_mark(self.held_tensors())

    def adopt_streams(self, mark) -> None:
        """``table.adopt_streams`` over every block's card."""
        from caps_tpu_torch.backends.cuda.table import adopt_streams
        adopt_streams(self.held_tensors(), mark)

    def resident_bytes(self) -> List[int]:
        """Per slot, the bytes of its blocks' per-row tensors."""
        return [sum(int(t.numel()) * t.element_size()
                    for c in p._cols.values() for t in _row_tensors(c))
                for p in self.parts]

    # -- gathers -------------------------------------------------------

    def gathered(self, cols: Optional[Sequence[str]] = None,
                 host: bool = False):
        """The table whole on the lead device (or only ``cols``; with
        ``host``, keeping the ingest mirrors)."""
        return gather_parts(self.backend, self.parts, cols, host)

    def realigned(self) -> "ShardedTable":
        """This table with each column's blocks of one kind, width and
        side columns (what an exchange between shards needs): as it is
        where they are already, else gathered and split anew."""
        if all(_uniform([p._cols[c] for p in self.parts])
               for c in self.columns):
            return self
        return split_table(self.gathered(), self.backend.mesh)

    def take_rows(self, idx: torch.Tensor, home=None) -> Dict[str, Column]:
        """Every column's rows ``idx`` (indices into the whole table's
        row order, as a CSR built at ingest holds them), on ``idx``'s
        device.  The indices are grouped by the block that holds them;
        each block takes only its own, at one capacity for every block
        (the largest group, a size of the size stream), and only those
        rows move, written back to their places.  The blocks are a
        placement's (equal capacities, rows in order).  The rows that
        leave slots other than ``home`` count as a gather."""
        t = self.realigned()
        k = len(t.parts)
        b = t.parts[0].capacity
        dev = idx.device
        m = int(idx.shape[0])
        owner = torch.div(idx, b, rounding_mode="floor").clamp(0, k - 1)
        order = torch.sort(owner, stable=True).indices
        counts = torch.bincount(owner, minlength=k)
        starts = torch.cumsum(counts, 0) - counts
        be = self.backend
        cap = min(m, be.bucket(be.consume_count(counts.max(),
                                                relation="cap")))
        ar = torch.arange(cap, device=dev)
        out: Dict[str, Column] = {}
        memo: dict = {}
        moved = []
        for j, p in enumerate(t.parts):
            pos = order[(starts[j] + ar).clamp(max=max(m - 1, 0))]
            target = torch.where(ar < counts[j], pos, m)
            local = (idx[pos] - j * b).clamp(0, b - 1)
            got = {c: col.take(local.to(p.backend.device))
                   for c, col in p._cols.items()}
            if p.backend.device != dev:
                got = {c: _to_lead(col, dev, memo) for c, col in got.items()}
            if p.backend.slot is not home:
                moved += [x for col in got.values() for x in _row_tensors(col)]
            out = {c: _scatter_rows(out.get(c), target, col, m)
                   for c, col in got.items()}
        _count_gather(be, moved)
        return {c: _head(col, m) for c, col in out.items()}

    # -- row-local operators ------------------------------------------

    def select(self, cols):
        return self._map(lambda p: p.select(cols))

    def rename(self, mapping):
        return self._map(lambda p: p.rename(mapping))

    def copy_column(self, src, dst):
        return self._map(lambda p: p.copy_column(src, dst))

    def with_literal_column(self, name, value, ctype):
        return self._map(lambda p: p.with_literal_column(name, value, ctype))

    def with_row_index(self, name):
        """Each row's index among the capacity slots of every block
        before it and its own (unique and ordered as the rows are)."""
        out, off = [], 0
        for p in self.parts:
            out.append(p.with_row_index(name, offset=off))
            off += p.capacity
        return ShardedTable(self.backend, out)

    def with_column(self, name, expr, header, parameters, ctype):
        return self._map(lambda p: p.with_column(name, expr, header,
                                                 parameters, ctype))

    def filter(self, expr, header, parameters):
        return self._map(lambda p: p.filter(expr, header, parameters))

    def drop_in(self, col, values):
        if not values:
            return self
        return self._map(lambda p: p.drop_in(col, values))

    def explode(self, list_col, out_col, out_type):
        return self._map(lambda p: p.explode(list_col, out_col, out_type))

    def pack_list(self, cols, out_col, out_type):
        return self._map(lambda p: p.pack_list(cols, out_col, out_type))

    def place(self) -> "ShardedTable":
        return self

    # -- joins and the hand-scheduled group-by ------------------------

    def join(self, other, how, pairs):
        from caps_tpu_torch.backends.cuda.table import mesh_join
        return mesh_join(self, other, how, pairs)

    def group(self, by, aggs):
        from caps_tpu_torch.backends.cuda.table import dense_group
        fast = dense_group(self.backend, self, by, aggs)
        if fast is not None:
            return fast
        return self.gathered().group(by, aggs)

    # -- operators that gather first ------------------------------------

    def union_all(self, other):
        return self.gathered().union_all(whole(other))

    def distinct(self):
        return self.gathered().distinct()

    def order_by(self, items):
        return self.gathered().order_by(items)

    def skip(self, n):
        return self.gathered().skip(n)

    def limit(self, n):
        return self.gathered().limit(n)

    def rows_where(self, col, value):
        """The live rows whose integer ``col`` equals ``value``: a binary
        search in each block's own sorted index (built once per block),
        the hits gathered to the lead."""
        return gather_parts(self.backend,
                            [p.rows_where(col, value) for p in self.parts])

    def max_int(self, col):
        got = [v for v in (p.max_int(col) for p in self.parts)
               if v is not None]
        return max(got) if got else None

    # -- materialization ----------------------------------------------

    def device_sync(self) -> None:
        for d in {str(p.backend.device): p for p in self.parts}.values():
            d.device_sync()

    def column_values(self, col):
        return self.gathered([col]).column_values(col)

    def rows(self):
        return self.gathered().rows()

    def distinct_counts(self, cols):
        return self.gathered(list(cols)).distinct_counts(cols)

    def host_column(self, col):
        """(values, ok) numpy view of an integer column: the blocks'
        ingest mirrors where every block has one (no read), else one
        gathered read."""
        cs = [p._cols.get(col) for p in self.parts]
        if cs[0] is None or cs[0].kind not in ("id", "int"):
            return None
        if all(c.host is not None for c in cs):
            n = self._exact_n()
            live = [np.arange(c.capacity) < p._exact_n()
                    for c, p in zip(cs, self.parts)]
            d = np.concatenate([c.host[0][lv] for c, lv in zip(cs, live)])
            v = np.concatenate([np.asarray(c.host[1], bool)[lv]
                                for c, lv in zip(cs, live)])
            cap = self.backend.bucket(n)
            dd = np.zeros(cap, dtype=d.dtype)
            vv = np.zeros(cap, dtype=bool)
            dd[:n], vv[:n] = d, v
            return dd, vv
        return self.gathered([col]).host_column(col)

    def host_values(self, col):
        return self.gathered([col]).host_values(col)


def resident_bytes(graph) -> Dict[str, object]:
    """A graph's column bytes per mesh slot (row-resident tables' blocks)
    and the bytes of its tables that stay whole on the lead."""
    per_slot: Optional[List[int]] = None
    whole_bytes = 0
    for et in tuple(graph.node_tables) + tuple(graph.rel_tables):
        t = et.table
        if isinstance(t, ShardedTable):
            got = t.resident_bytes()
            per_slot = got if per_slot is None else [
                a + b for a, b in zip(per_slot, got)]
        else:
            whole_bytes += t.nbytes
    return {"per_slot": per_slot or [], "whole": whole_bytes}
