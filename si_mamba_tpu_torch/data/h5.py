"""A reader of the HDF5 subset that the datasets' files use, without h5py.

The counterpart of the ``h5py.File`` reads in ``si_mamba_tpu/data/io.py`` and
``si_mamba_tpu/data/datasets.py`` (ModelNet40's ``ply_data_*.h5`` shards,
ScanObjectNN's splits), in pure Python and numpy with the standard library's
``zlib``. It reads:

- superblock versions 0, 2 and 3;
- object header versions 1 and 2 (with their continuation blocks);
- groups as a symbol table (v1 B-tree and local heap) or as compact link
  messages;
- fixed-point (signed and unsigned, 1/2/4/8 bytes) and IEEE float (4/8
  bytes) datatypes, in either byte order;
- compact and contiguous layouts (layout message v3 and v4), and the chunked
  layout of layout message v3 (v1 B-tree index) with the deflate (1) and
  shuffle (2) filters.

Storage never written (a contiguous dataset never allocated, a chunk never
written) reads as the dataset's fill value, as the library reads it.

Anything else (another superblock, a datatype class, a filter id, the chunked
layout of layout message v4 that ``libver='latest'`` writes, dense link
storage, external data files, any other message of a dataset's header, or
storage never written where the library leaves it undefined: no fill value
defined, or a fill time of 'never') raises ``NotImplementedError`` naming it:
no object is skipped unread. :func:`read_h5` returns every dataset of the file by its path.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# message types that carry nothing a dataset's values or a group's links need
_IGNORED_MESSAGES = {
    0x00: "NIL", 0x0A: "group info",
    0x0C: "attribute", 0x0D: "object comment", 0x0E: "modification time (old)",
    0x12: "modification time", 0x13: "B-tree 'K' values", 0x15: "attribute info",
    0x16: "object reference count",
}
_DATASPACE, _LINK_INFO, _DATATYPE, _LINK, _LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = (
    0x01, 0x02, 0x03, 0x06, 0x08, 0x0B, 0x10, 0x11)
_FILL_OLD, _FILL = 0x04, 0x05
_DATASET_MESSAGES = {_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS, _FILL_OLD, _FILL}
_MESSAGE_NAMES = {0x07: "external data files", 0x09: "bogus", 0x0F: "shared message table",
                  0x14: "driver info", 0x17: "file space info"}
_FILL_NEVER = 1  # the fill time at which the library leaves unwritten storage undefined
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
                 6: "scaleoffset", 32000: "lzf", 32001: "blosc", 32004: "lz4"}


class _File:
    """The file's bytes, its offset and length sizes and base address."""

    def __init__(self, data: bytes, path: str):
        self.data, self.path = data, path
        self.base = data.find(SIGNATURE)
        while self.base > 0 and self.base % 512:
            self.base = data.find(SIGNATURE, self.base + 1)
        if self.base < 0:
            raise ValueError(f"{path}: not an HDF5 file (no signature)")
        self.version = data[self.base + 8]
        if self.version == 0:
            self.size_off, self.size_len = data[self.base + 13], data[self.base + 14]
        elif self.version in (2, 3):
            self.size_off, self.size_len = data[self.base + 9], data[self.base + 10]
        else:
            raise NotImplementedError(f"{path}: HDF5 superblock version {self.version}")
        self.undefined = (1 << (8 * self.size_off)) - 1

    def unpack(self, pos: int, *sizes: int) -> list[int]:
        out = []
        for n in sizes:
            out.append(int.from_bytes(self.data[pos:pos + n], "little"))
            pos += n
        return out

    def addr(self, pos: int) -> int:
        return self.unpack(pos, self.size_off)[0]

    def at(self, address: int) -> int:
        """A file position from an address relative to the base."""
        return self.base + address

    def root(self) -> int:
        """The root group's object header address."""
        b, o = self.base, self.size_off
        if self.version == 0:
            # 24 bytes of fields, four addresses, then the root symbol table entry
            return self.addr(b + 24 + 4 * o + o)
        return self.addr(b + 12 + 3 * o)


def _messages(f: _File, address: int) -> list[tuple[int, bytes]]:
    """Every message of the object header at ``address``: (type, body)."""
    pos = f.at(address)
    out: list[tuple[int, bytes]] = []
    if f.data[pos:pos + 4] == b"OHDR":
        version, flags = f.data[pos + 4], f.data[pos + 5]
        if version != 2:
            raise NotImplementedError(f"{f.path}: object header version {version}")
        p = pos + 6
        if flags & 0x20:
            p += 16  # access, modification, change and birth times
        if flags & 0x10:
            p += 4  # attribute storage phase change values
        size_width = 1 << (flags & 0x03)
        size = f.unpack(p, size_width)[0]
        p += size_width
        blocks = [(p, size)]
        order = 2 if flags & 0x04 else 0
        while blocks:
            start, length = blocks.pop(0)
            p, end = start, start + length
            while p + 4 + order <= end:
                mtype, msize, mflags = f.data[p], f.unpack(p + 1, 2)[0], f.data[p + 3]
                p += 4 + order
                body = f.data[p:p + msize]
                p += msize
                _check_flags(f, mtype, mflags)
                if mtype == _CONTINUATION:
                    off = int.from_bytes(body[:f.size_off], "little")
                    length2 = int.from_bytes(body[f.size_off:f.size_off + f.size_len], "little")
                    cpos = f.at(off)
                    if f.data[cpos:cpos + 4] != b"OCHK":
                        raise ValueError(f"{f.path}: bad continuation block at {off}")
                    blocks.append((cpos + 4, length2 - 8))  # signature, checksum
                else:
                    out.append((mtype, body))
        return out
    version = f.data[pos]
    if version != 1:
        raise NotImplementedError(f"{f.path}: object header version {version}")
    n_messages = f.unpack(pos + 2, 2)[0]
    size = f.unpack(pos + 8, 4)[0]
    blocks = [(pos + 16, size)]
    while blocks and len(out) < n_messages:
        start, length = blocks.pop(0)
        p, end = start, start + length
        while p + 8 <= end:
            mtype, msize = f.unpack(p, 2, 2)
            mflags = f.data[p + 4]
            body = f.data[p + 8:p + 8 + msize]
            p += 8 + msize
            _check_flags(f, mtype, mflags)
            if mtype == _CONTINUATION:
                off = int.from_bytes(body[:f.size_off], "little")
                length2 = int.from_bytes(body[f.size_off:f.size_off + f.size_len], "little")
                blocks.append((f.at(off), length2))
            out.append((mtype, body))
    return [(t, b) for t, b in out if t != _CONTINUATION]


def _check_flags(f: _File, mtype: int, mflags: int) -> None:
    if mflags & 0x02 and mtype not in _IGNORED_MESSAGES:
        raise NotImplementedError(f"{f.path}: shared object header message of type {mtype:#x}")


def _dataspace(body: bytes, f: _File) -> tuple[int, ...]:
    version, rank, flags = body[0], body[1], body[2]
    if version == 1:
        p = 8
    elif version == 2:
        if body[3] == 2:
            raise NotImplementedError(f"{f.path}: null dataspace")
        p = 4
    else:
        raise NotImplementedError(f"{f.path}: dataspace message version {version}")
    n = f.size_len
    return tuple(int.from_bytes(body[p + i * n:p + (i + 1) * n], "little") for i in range(rank))


def _datatype(body: bytes, f: _File) -> np.dtype:
    cls, bits = body[0] & 0x0F, int.from_bytes(body[1:4], "little")
    size = int.from_bytes(body[4:8], "little")
    names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
             7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
    if cls in (0, 1):
        offset, precision = struct.unpack_from("<HH", body, 8)
    if cls == 0:
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise NotImplementedError(f"{f.path}: fixed-point datatype of {size} bytes, bit "
                                      f"offset {offset}, precision {precision}")
        kind = "i" if bits & 0x08 else "u"
    elif cls == 1:
        if bits & 0x40 or size not in (4, 8) or offset or precision != 8 * size:
            raise NotImplementedError(f"{f.path}: floating-point datatype of {size} bytes, "
                                      f"bit fields {bits:#x}, precision {precision}")
        kind = "f"
    else:
        raise NotImplementedError(f"{f.path}: datatype class {cls} "
                                  f"({names.get(cls, 'unknown')})")
    order = ">" if bits & 0x01 else "<"
    return np.dtype(f"{order}{kind}{size}")


def _filters(body: bytes, f: _File) -> list[tuple[int, list[int]]]:
    """The filter pipeline: [(filter id, client data), ...] in write order."""
    version, n = body[0], body[1]
    p = 8 if version == 1 else 2
    if version not in (1, 2):
        raise NotImplementedError(f"{f.path}: filter pipeline message version {version}")
    out = []
    for _ in range(n):
        fid = int.from_bytes(body[p:p + 2], "little")
        p += 2
        name_len = 0
        if version == 1 or fid >= 256:
            name_len = int.from_bytes(body[p:p + 2], "little")
            p += 2
        _flags, n_values = struct.unpack_from("<HH", body, p)
        p += 4
        if version == 1:
            name_len = (name_len + 7) // 8 * 8
        p += name_len
        values = list(struct.unpack_from(f"<{n_values}I", body, p))
        p += 4 * n_values
        if version == 1 and n_values % 2:
            p += 4
        if fid not in (1, 2):
            raise NotImplementedError(f"{f.path}: filter id {fid} "
                                      f"({_FILTER_NAMES.get(fid, 'unknown')})")
        out.append((fid, values))
    return out


def _unfilter(raw: bytes, filters, mask: int) -> bytes:
    for i in reversed(range(len(filters))):
        if mask & (1 << i):
            continue
        fid, values = filters[i]
        if fid == 1:
            raw = zlib.decompress(raw)
        else:  # shuffle: the k-th bytes of every element, one plane after another
            size = values[0]
            n = len(raw) // size
            planes = np.frombuffer(raw[:n * size], np.uint8).reshape(size, n)
            raw = planes.T.tobytes() + raw[n * size:]
    return raw


def _fill(body: dict, f: _File, dtype: np.dtype) -> np.ndarray | None:
    """The dataset's fill value (a 0-d array of ``dtype``: the one given, or
    the library's default of zero), or None where the library leaves storage
    never written undefined (no fill value defined, or a fill time of
    'never'), from its fill value messages ``body`` {type: body}."""
    value, fill_time, defined = b"", 0, True
    if _FILL in body:
        b = body[_FILL]
        if b[0] in (1, 2):
            fill_time, defined = b[2], bool(b[3])
            if defined:
                size = int.from_bytes(b[4:8], "little")
                value = b[8:8 + size]
        elif b[0] == 3:
            flags = b[1]
            fill_time, defined = (flags >> 2) & 0x03, not flags & 0x10
            if flags & 0x20:
                size = int.from_bytes(b[2:6], "little")
                value = b[6:6 + size]
        else:
            raise NotImplementedError(f"{f.path}: fill value message version {b[0]}")
    elif _FILL_OLD in body:
        size = int.from_bytes(body[_FILL_OLD][:4], "little")
        value = body[_FILL_OLD][4:4 + size]
    if not defined or fill_time == _FILL_NEVER:
        return None
    if not value:
        return np.zeros((), dtype)
    if len(value) != dtype.itemsize:
        raise NotImplementedError(f"{f.path}: a fill value of {len(value)} bytes for {dtype}")
    return np.frombuffer(value, dtype, 1).reshape(()).copy()


def _unwritten(f: _File, name: str, fill: np.ndarray | None, what: str) -> np.ndarray:
    if fill is None:
        raise NotImplementedError(f"{f.path}: dataset {name} has {what} and no fill value "
                                  f"(the library leaves it undefined)")
    return fill


def _chunks(f: _File, address: int, rank: int):
    """Every (chunk size, filter mask, offsets, data position) of the v1
    B-tree of raw-data chunks at ``address``."""
    pos = f.at(address)
    if f.data[pos:pos + 4] != b"TREE" or f.data[pos + 4] != 1:
        raise ValueError(f"{f.path}: no chunk B-tree at {address}")
    level, used = f.data[pos + 5], f.unpack(pos + 6, 2)[0]
    p = pos + 8 + 2 * f.size_off
    key = 8 + 8 * (rank + 1)
    for _ in range(used):
        size, mask = f.unpack(p, 4, 4)
        offsets = f.unpack(p + 8, *([8] * rank))
        child = f.addr(p + key)
        p += key + f.size_off
        if level:
            yield from _chunks(f, child, rank)
        else:
            yield size, mask, offsets, f.at(child)


def _layout(body: bytes, f: _File, name: str, shape, dtype, filters,
            fill: np.ndarray | None) -> np.ndarray:
    version, cls = body[0], body[1]
    if version not in (3, 4):
        raise NotImplementedError(f"{f.path}: data layout message version {version}")
    count = int(np.prod(shape, dtype=np.int64))
    if cls == 0:  # compact
        size = int.from_bytes(body[2:4], "little")
        return np.frombuffer(body[4:4 + size], dtype, count).reshape(shape).copy()
    if cls == 1:  # contiguous
        address = int.from_bytes(body[2:2 + f.size_off], "little")
        if address == f.undefined:
            return np.full(shape, _unwritten(f, name, fill, "storage never written"), dtype)
        return np.frombuffer(f.data, dtype, count, f.at(address)).reshape(shape).copy()
    if cls == 2 and version == 3:
        dims = body[2]
        address = int.from_bytes(body[3:3 + f.size_off], "little")
        p = 3 + f.size_off
        chunk = struct.unpack_from(f"<{dims}I", body, p)[:-1]
        n_chunks = int(np.prod([-(-n // c) for n, c in zip(shape, chunk)], dtype=np.int64))
        chunks = [] if address == f.undefined else list(_chunks(f, address, len(shape)))
        out = np.empty(shape, dtype)
        if len(chunks) < n_chunks:
            out[...] = _unwritten(f, name, fill, f"{n_chunks - len(chunks)} of {n_chunks} "
                                  f"chunks never written")
        for size, mask, offsets, pos in chunks:
            raw = _unfilter(f.data[pos:pos + size], filters, mask)
            block = np.frombuffer(raw, dtype, int(np.prod(chunk))).reshape(chunk)
            dst = tuple(slice(o, min(o + c, n)) for o, c, n in zip(offsets, chunk, shape))
            out[dst] = block[tuple(slice(0, s.stop - s.start) for s in dst)]
        return out
    names = {0: "compact", 1: "contiguous", 2: "chunked", 3: "virtual"}
    raise NotImplementedError(f"{f.path}: {names.get(cls, cls)} layout of data layout message "
                              f"v{version} (its chunk indexes are not read)")


def _heap_name(f: _File, heap: int, offset: int) -> str:
    pos = f.at(heap)
    if f.data[pos:pos + 4] != b"HEAP":
        raise ValueError(f"{f.path}: no local heap at {heap}")
    data = f.at(f.addr(pos + 8 + 2 * f.size_len)) + offset
    return f.data[data:f.data.index(b"\0", data)].decode()


def _symbol_table_links(f: _File, btree: int, heap: int) -> list[tuple[str, int]]:
    """(name, object header address) of every entry of a v1 group B-tree."""
    pos = f.at(btree)
    if f.data[pos:pos + 4] != b"TREE" or f.data[pos + 4] != 0:
        raise ValueError(f"{f.path}: no group B-tree at {btree}")
    level, used = f.data[pos + 5], f.unpack(pos + 6, 2)[0]
    p = pos + 8 + 2 * f.size_off + f.size_len  # siblings, then key 0
    links = []
    for _ in range(used):
        child = f.addr(p)
        p += f.size_off + f.size_len
        if level:
            links += _symbol_table_links(f, child, heap)
            continue
        node = f.at(child)
        if f.data[node:node + 4] != b"SNOD":
            raise ValueError(f"{f.path}: no symbol table node at {child}")
        entry = 2 * f.size_off + 24
        for i in range(f.unpack(node + 6, 2)[0]):
            e = node + 8 + i * entry
            links.append((_heap_name(f, heap, f.addr(e)), f.addr(e + f.size_off)))
    return links


def _link(body: bytes, f: _File) -> tuple[str, int]:
    flags, p = body[1], 2
    kind = 0
    if flags & 0x08:
        kind, p = body[p], p + 1
    if flags & 0x04:
        p += 8
    if flags & 0x10:
        p += 1
    width = 1 << (flags & 0x03)
    n = int.from_bytes(body[p:p + width], "little")
    name = body[p + width:p + width + n].decode()
    if kind != 0:
        raise NotImplementedError(f"{f.path}: link {name!r} of type {kind} (soft or external)")
    return name, int.from_bytes(body[p + width + n:p + width + n + f.size_off], "little")


def _walk(f: _File, address: int, prefix: str, out: dict, seen: set) -> None:
    if address in seen:
        return
    seen.add(address)
    msgs = _messages(f, address)
    types = {t for t, _ in msgs}
    if _LAYOUT in types:
        name = prefix.rstrip("/")
        other = sorted(types - _DATASET_MESSAGES - _IGNORED_MESSAGES.keys())
        if other:
            raise NotImplementedError(f"{f.path}: object header message type {other[0]:#x} "
                                      f"({_MESSAGE_NAMES.get(other[0], 'unknown')}) in "
                                      f"dataset {name}")
        body = dict(msgs)
        shape = _dataspace(body[_DATASPACE], f)
        dtype = _datatype(body[_DATATYPE], f)
        filters = _filters(body[_FILTERS], f) if _FILTERS in body else []
        out[name] = _layout(body[_LAYOUT], f, name, shape, dtype, filters,
                            _fill(body, f, dtype))
        return
    links = []
    for t, body in msgs:
        if t == _SYMBOL_TABLE:
            links += _symbol_table_links(f, int.from_bytes(body[:f.size_off], "little"),
                                         int.from_bytes(body[f.size_off:2 * f.size_off],
                                                        "little"))
        elif t == _LINK:
            links.append(_link(body, f))
        elif t == _LINK_INFO:
            p = 2 + (8 if body[1] & 0x01 else 0)
            if int.from_bytes(body[p:p + f.size_off], "little") != f.undefined:
                raise NotImplementedError(f"{f.path}: dense link storage (fractal heap) in "
                                          f"group {prefix or '/'}")
        elif t not in _IGNORED_MESSAGES and t not in (_DATASPACE, _DATATYPE, _FILTERS):
            raise NotImplementedError(f"{f.path}: object header message type {t:#x} "
                                      f"({_MESSAGE_NAMES.get(t, 'unknown')}) in "
                                      f"{prefix or '/'}")
    for name, child in sorted(links):
        _walk(f, child, f"{prefix}{name}/", out, seen)


def read_h5(path: str) -> dict[str, np.ndarray]:
    """Every dataset of the HDF5 file at ``path``: {path in the file (``data``,
    ``label``, ``group/name``): array}, in the file's dtype and shape."""
    with open(path, "rb") as fh:
        f = _File(fh.read(), path)
    out: dict[str, np.ndarray] = {}
    _walk(f, f.root(), "", out, set())
    return out
