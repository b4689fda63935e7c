"""A reader and a writer for the subset of HDF5 that the packed corpus uses.

The JAX package writes its feature files with h5py
(``sound_event_detection_dcase2017_task4_tpu/data/hdf5.py:118-155`` and
``:191-193``); the port reads and writes the same files with numpy alone.
The subset is what h5py writes by default for them:

* superblock version 0 (or 1) at offset 0, any size of offsets and lengths;
* the root group as a symbol table (a version-1 B-tree, symbol-table nodes
  and a local heap) holding datasets only;
* version-1 object headers, with continuation blocks;
* contiguous datasets, unallocated ones read as zeros;
* fixed-size datatypes: little- or big-endian integers and IEEE floats, and
  fixed-length byte strings (``S120`` for ``audio_name``);
* compact attributes in the object header (a scalar float ``scale`` on
  ``waveform``, int attributes on the file).

Anything else raises ``ValueError`` naming the feature: chunked or compact
layout, filters or compression, superblock version 2 or later, version-2
object headers, dense attribute storage, variable-length types, shared
messages, nested groups, a user block.

:func:`open` gives each dataset's dtype, shape, file offset and attributes,
and its array through a read-only ``np.memmap`` (nothing is read until it is
indexed). :func:`create` declares every dataset's shape and dtype up front,
writes the metadata, and returns writable memmaps for the caller to fill in
slices; h5py reads the result.
"""

from __future__ import annotations

import builtins
import dataclasses
import math
import mmap
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

__all__ = ["Dataset", "File", "open", "create"]

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
_NIL, _DATASPACE, _DATATYPE, _FILL, _LAYOUT = 0x0, 0x1, 0x3, 0x5, 0x8
_FILTERS, _ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE = 0xB, 0xC, 0x10, 0x11
_ATTRIBUTE_INFO, _LINK_INFO, _LINK = 0x15, 0x2, 0x6


@dataclasses.dataclass
class Dataset:
    """One dataset of the root group. ``offset`` is ``None`` for storage
    that was never allocated (read as zeros)."""

    name: str
    dtype: np.dtype
    shape: Tuple[int, ...]
    offset: Optional[int]
    attrs: Dict[str, object]


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Parser:
    def __init__(self, buf, path: str):
        self.b = buf
        self.path = path
        if buf[:8] != _SIGNATURE:
            raise ValueError(f"{path}: not an HDF5 file (no signature at "
                             "offset 0)")
        b, base = buf, 0
        version = b[base + 8]
        if version >= 2:
            raise ValueError(
                f"{path}: superblock version {version} is outside the HDF5 "
                "subset (versions 0 and 1, h5py's default)")
        self.so, self.sl = b[base + 13], b[base + 14]
        p = base + 24 + (4 if version == 1 else 0)
        self.base = self._uint(p, self.so)
        self.root = self._addr(p + 4 * self.so + self.so)   # the entry's header

    def _uint(self, p: int, size: int) -> int:
        return int.from_bytes(self.b[p:p + size], "little")

    def _addr(self, p: int) -> Optional[int]:
        a = self._uint(p, self.so)
        return None if a == (1 << (8 * self.so)) - 1 else a + self.base

    def messages(self, addr: int):
        """``(type, data offset, size)`` of every message of the version-1
        object header at ``addr``, continuation blocks followed."""
        b = self.b
        if b[addr:addr + 4] == b"OHDR":
            raise ValueError(f"{self.path}: version-2 object headers are "
                             "outside the HDF5 subset")
        if b[addr] != 1:
            raise ValueError(f"{self.path}: object header version {b[addr]} "
                             f"at {addr} is outside the HDF5 subset")
        size = struct.unpack_from("<I", b, addr + 8)[0]
        chunks = [(addr + 16, size)]
        while chunks:
            start, length = chunks.pop(0)
            p = start
            while p + 8 <= start + length:
                mtype, msize, flags = struct.unpack_from("<HHB", b, p)
                data = p + 8
                if flags & 0x02:
                    raise ValueError(f"{self.path}: shared object header "
                                     "messages are outside the HDF5 subset")
                if mtype == _CONTINUATION:
                    chunks.append((self._addr(data),
                                   self._uint(data + self.so, self.sl)))
                else:
                    yield mtype, data, msize
                p = data + msize

    def root_entries(self):
        """``name → object header address`` of the root group."""
        stab = [d for t, d, _ in self.messages(self.root) if t == _SYMBOL_TABLE]
        if not stab:
            raise ValueError(f"{self.path}: the root group is not a symbol "
                             "table (link messages are outside the subset)")
        btree, heap = self._addr(stab[0]), self._addr(stab[0] + self.so)
        b, sl = self.b, self.sl
        if b[heap:heap + 4] != b"HEAP":
            raise ValueError(f"{self.path}: bad local heap at {heap}")
        names_at = self._addr(heap + 8 + 2 * sl)
        entries = {}
        for snod in self._btree_leaves(btree):
            if b[snod:snod + 4] != b"SNOD":
                raise ValueError(f"{self.path}: bad symbol-table node at {snod}")
            for i in range(struct.unpack_from("<H", b, snod + 6)[0]):
                e = snod + 8 + i * (2 * self.so + 24)
                start = names_at + self._uint(e, self.so)
                name = bytes(b[start:b.find(b"\0", start)]).decode("utf-8")
                entries[name] = self._addr(e + self.so)
        return entries

    def _btree_leaves(self, addr):
        b = self.b
        if addr is None:
            return
        if b[addr:addr + 4] != b"TREE" or b[addr + 4] != 0:
            raise ValueError(f"{self.path}: bad group B-tree node at {addr}")
        level = b[addr + 5]
        used = struct.unpack_from("<H", b, addr + 6)[0]
        first = addr + 8 + 2 * self.so + self.sl
        for i in range(used):
            child = self._addr(first + i * (self.sl + self.so))
            if level:
                yield from self._btree_leaves(child)
            else:
                yield child

    def dtype(self, p: int) -> np.dtype:
        b = self.b
        cls = b[p] & 0x0F
        bits = b[p + 1] | (b[p + 2] << 8)
        size = struct.unpack_from("<I", b, p + 4)[0]
        order = ">" if bits & 1 else "<"
        if cls == 0:                                    # fixed point
            offset, precision = struct.unpack_from("<HH", b, p + 8)
            if offset or precision != 8 * size:
                raise ValueError(f"{self.path}: integer with bit offset "
                                 f"{offset}, precision {precision}")
            return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
        if cls == 1:                                    # IEEE float
            want = {2: (10, 5, 10), 4: (23, 8, 23), 8: (52, 11, 52)}
            _, precision, eloc, esize, _, msize = struct.unpack_from(
                "<HHBBBB", b, p + 8)
            if (size not in want or precision != 8 * size
                    or (eloc, esize, msize) != want[size]):
                raise ValueError(f"{self.path}: non-IEEE float of {size} bytes")
            return np.dtype(f"{order}f{size}")
        if cls == 3:                                    # fixed-length string
            return np.dtype(f"S{size}")
        if cls == 9:
            raise ValueError(f"{self.path}: variable-length types "
                             "(strings, sequences) are outside the HDF5 subset")
        raise ValueError(f"{self.path}: datatype class {cls} is outside the "
                         "HDF5 subset")

    def shape(self, p: int) -> Tuple[int, ...]:
        b = self.b
        version, rank = b[p], b[p + 1]
        if version == 1:
            dims = p + 8
        elif version == 2:
            if b[p + 3] == 2:
                raise ValueError(f"{self.path}: null dataspace")
            dims = p + 4
        else:
            raise ValueError(f"{self.path}: dataspace version {version}")
        return tuple(self._uint(dims + i * self.sl, self.sl) for i in range(rank))

    def attribute(self, p: int):
        b = self.b
        version = b[p]
        if version not in (1, 2, 3):
            raise ValueError(f"{self.path}: attribute message version {version}")
        if version > 1 and b[p + 1] & 3:
            raise ValueError(f"{self.path}: shared attribute datatypes are "
                             "outside the HDF5 subset")
        name_len, dt_len, ds_len = struct.unpack_from("<HHH", b, p + 2)
        q = p + 8 + (1 if version == 3 else 0)
        fit = _pad8 if version == 1 else (lambda n: n)
        name = bytes(b[q:q + name_len]).split(b"\0")[0].decode("utf-8")
        q += fit(name_len)
        dtype = self.dtype(q)
        q += fit(dt_len)
        shape = self.shape(q)
        q += fit(ds_len)
        count = math.prod(shape)
        arr = np.frombuffer(b[q:q + count * dtype.itemsize], dtype, count)
        arr = arr.reshape(shape).copy()
        return name, (arr[()] if shape == () else arr)

    def dataset(self, name: str, addr: int) -> Dataset:
        dtype = shape = layout = None
        attrs = {}
        for mtype, p, _ in self.messages(addr):
            if mtype == _DATATYPE:
                dtype = self.dtype(p)
            elif mtype == _DATASPACE:
                shape = self.shape(p)
            elif mtype == _LAYOUT:
                layout = p
            elif mtype == _FILTERS:
                raise ValueError(f"{self.path}: {name!r} has a filter pipeline "
                                 "(compression or other filters), outside "
                                 "the HDF5 subset")
            elif mtype == _ATTRIBUTE:
                k, v = self.attribute(p)
                attrs[k] = v
            elif mtype == _ATTRIBUTE_INFO:
                flags = self.b[p + 1]
                if self._addr(p + 2 + (2 if flags & 1 else 0)) is not None:
                    raise ValueError(f"{self.path}: {name!r} uses dense "
                                     "attribute storage, outside the subset")
            elif mtype in (_SYMBOL_TABLE, _LINK_INFO, _LINK):
                raise ValueError(f"{self.path}: {name!r} is a group; nested "
                                 "groups are outside the HDF5 subset")
        if dtype is None or shape is None or layout is None:
            raise ValueError(f"{self.path}: {name!r} is not a dataset")
        b = self.b
        version, cls = b[layout], b[layout + 1]
        if version != 3:
            raise ValueError(f"{self.path}: {name!r}: data layout message "
                             f"version {version} is outside the subset (3)")
        if cls == 1:
            return Dataset(name, dtype, shape, self._addr(layout + 2), attrs)
        what = {0: "compact", 2: "chunked", 3: "virtual"}.get(cls, f"class {cls}")
        raise ValueError(f"{self.path}: {name!r} has {what} layout; only "
                         "contiguous datasets are in the subset")

    def root_attrs(self) -> Dict[str, object]:
        out = {}
        for mtype, p, _ in self.messages(self.root):
            if mtype == _ATTRIBUTE:
                k, v = self.attribute(p)
                out[k] = v
            elif (mtype == _ATTRIBUTE_INFO and self._addr(
                    p + 2 + (2 if self.b[p + 1] & 1 else 0)) is not None):
                raise ValueError(f"{self.path}: dense attribute storage is "
                                 "outside the HDF5 subset")
        return out


class File:
    """A parsed file of the subset: ``datasets`` (name → :class:`Dataset`)
    and the file's ``attrs``. ``file[name]`` is the dataset's array, a
    read-only ``np.memmap`` (zeros for unallocated storage)."""

    def __init__(self, path: str):
        self.path = os.fspath(path)
        with builtins.open(self.path, "rb") as f:
            if os.fstat(f.fileno()).st_size < len(_SIGNATURE):
                raise ValueError(f"{self.path}: not an HDF5 file (too short)")
            with mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as buf:
                parser = _Parser(buf, self.path)
                self.attrs = parser.root_attrs()
                self.datasets = {name: parser.dataset(name, addr)
                                 for name, addr in parser.root_entries().items()}

    def __contains__(self, name: str) -> bool:
        return name in self.datasets

    def __getitem__(self, name: str) -> np.ndarray:
        d = self.datasets[name]
        if d.offset is None or math.prod(d.shape) == 0:
            return np.zeros(d.shape, d.dtype)
        return np.memmap(self.path, d.dtype, "r", offset=d.offset, shape=d.shape)



def open(path: str) -> File:  # noqa: A001 - the module's reader, as h5py.File
    """Parse ``path`` (see :class:`File`)."""
    return File(path)


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def _u(n: int, size: int = 8) -> bytes:
    return int(n).to_bytes(size, "little")


def _dtype_message(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    order = 1 if dtype.byteorder == ">" else 0
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return (bytes([0x10, bits, 0, 0]) + _u(size, 4)
                + struct.pack("<HH", 0, 8 * size))
    if dtype.kind == "f" and size in (4, 8):
        eloc, esize, msize, bias = {4: (23, 8, 23, 127),
                                    8: (52, 11, 52, 1023)}[size]
        return (bytes([0x11, 0x20 | order, 8 * size - 1, 0]) + _u(size, 4)
                + struct.pack("<HHBBBBI", 0, 8 * size, eloc, esize, 0, msize,
                              bias))
    if dtype.kind == "S":
        return bytes([0x13, 0x01, 0, 0]) + _u(size, 4)       # null-padded ASCII
    raise ValueError(f"dtype {dtype} is outside the HDF5 subset")


def _dataspace_message(shape) -> bytes:
    rank = len(shape)
    dims = b"".join(_u(d) for d in shape)
    return bytes([1, rank, 1 if rank else 0, 0]) + b"\0" * 4 + dims + (
        dims if rank else b"")


def _attribute_message(name: str, value) -> bytes:
    arr = np.asarray(value)
    if arr.dtype.kind not in "iufS":
        raise TypeError(f"attribute {name!r}: {arr.dtype} is outside the subset")
    if arr.dtype.kind == "i":
        arr = arr.astype("<i8") if arr.dtype.itemsize < 8 else arr
    dt, ds = _dtype_message(arr.dtype), _dataspace_message(arr.shape)
    nm = name.encode("utf-8") + b"\0"

    def pad(x):
        return x + b"\0" * (_pad8(len(x)) - len(x))

    return (struct.pack("<BBHHH", 1, 0, len(nm), len(dt), len(ds))
            + pad(nm) + pad(dt) + pad(ds) + np.ascontiguousarray(arr).tobytes())


def _object_header(messages) -> bytes:
    """A version-1 object header: ``[(type, flags, data), ...]``."""
    body = b""
    for mtype, flags, data in messages:
        data = data + b"\0" * (_pad8(len(data)) - len(data))
        body += struct.pack("<HHB3x", mtype, len(data), flags) + data
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def create(path: str, datasets: Mapping[str, tuple],
           attrs: Optional[Mapping[str, object]] = None) -> Dict[str, np.ndarray]:
    """Write the metadata of a new file and return writable arrays.

    ``datasets`` maps a name to ``(shape, dtype)`` or ``(shape, dtype,
    attrs)``; ``attrs`` are the file's attributes (numbers or numeric
    arrays). Returns ``name → np.memmap`` opened ``r+`` at each dataset's
    storage (an empty array for a dataset with no elements); fill them in
    slices and flush or drop them. The file's storage is preallocated, so a
    region never written reads as zeros.
    """
    names = sorted(datasets, key=lambda s: s.encode("utf-8"))
    specs = {}
    for name in names:
        spec = datasets[name]
        shape, dtype = tuple(int(d) for d in spec[0]), np.dtype(spec[1])
        _dtype_message(dtype)                       # raises outside the subset
        specs[name] = (shape, dtype, dict(spec[2]) if len(spec) > 2 else {})

    leaf_k, inner_k = max(4, -(-len(names) // 2)), 16
    heap_data = b"\0" * 8
    name_off = {}
    for name in names:
        name_off[name] = len(heap_data)
        raw = name.encode("utf-8") + b"\0"
        heap_data += raw + b"\0" * (_pad8(len(raw)) - len(raw))

    # layout: superblock, root header, heap, B-tree, SNOD, dataset headers,
    # then each dataset's storage aligned to 64 bytes
    root_msgs = [(_SYMBOL_TABLE, 0, b"\0" * 16)] + [
        (_ATTRIBUTE, 0, _attribute_message(k, v)) for k, v in (attrs or {}).items()]
    root_at = 96
    heap_at = root_at + len(_object_header(root_msgs))
    btree_at = heap_at + 32 + len(heap_data)
    snod_at = btree_at + 24 + (2 * inner_k + 1) * 8 + 2 * inner_k * 8
    header_at = snod_at + 8 + 2 * leaf_k * 40

    def ds_header(name, storage_at):
        shape, dtype, ds_attrs = specs[name]
        nbytes = math.prod(shape) * dtype.itemsize
        layout = bytes([3, 1]) + _u(_UNDEF if not nbytes else storage_at) + _u(nbytes)
        msgs = [(_DATASPACE, 0, _dataspace_message(shape)),
                (_DATATYPE, 1, _dtype_message(dtype)),
                (_FILL, 1, bytes([2, 2, 2, 1]) + _u(0, 4)),
                (_LAYOUT, 0, layout)]
        msgs += [(_ATTRIBUTE, 0, _attribute_message(k, v))
                 for k, v in ds_attrs.items()]
        return _object_header(msgs)

    headers, p = {}, header_at
    for name in names:
        headers[name] = p
        p += len(ds_header(name, 0))
    storage, end = {}, p
    for name in names:
        shape, dtype, _ = specs[name]
        end = (end + 63) & ~63
        storage[name] = end
        end += math.prod(shape) * dtype.itemsize

    root_msgs[0] = (_SYMBOL_TABLE, 0, _u(btree_at) + _u(heap_at))
    super_block = (_SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                   + struct.pack("<HHI", leaf_k, inner_k, 0)
                   + _u(0) + _u(_UNDEF) + _u(end) + _u(_UNDEF)
                   + _u(0) + _u(root_at) + _u(1, 4) + b"\0" * 4
                   + _u(btree_at) + _u(heap_at))
    heap = (b"HEAP" + bytes([0, 0, 0, 0]) + _u(len(heap_data)) + _u(1)
            + _u(heap_at + 32) + heap_data)
    btree = b"TREE" + bytes([0, 0]) + struct.pack("<H", 1 if names else 0)
    btree += _u(_UNDEF) + _u(_UNDEF) + _u(0)
    if names:
        btree += _u(snod_at) + _u(name_off[names[-1]])
    snod = b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(names))
    for name in names:
        snod += _u(name_off[name]) + _u(headers[name]) + b"\0" * 24

    with builtins.open(path, "wb") as f:
        f.truncate(end)
        for at, blob in ((0, super_block), (root_at, _object_header(root_msgs)),
                         (heap_at, heap), (btree_at, btree), (snod_at, snod)):
            f.seek(at)
            f.write(blob)
        for name in names:
            f.seek(headers[name])
            f.write(ds_header(name, storage[name]))
    out = {}
    for name in names:
        shape, dtype, _ = specs[name]
        out[name] = (np.memmap(path, dtype, "r+", offset=storage[name],
                               shape=shape)
                     if math.prod(shape) else np.zeros(shape, dtype))
    return out
