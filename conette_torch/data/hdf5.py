"""A small HDF5 reader and writer in numpy, for the packs of ``data/hdf.py``.

``data/hdf.py`` (a copy of the JAX package's module) calls h5py; the port
does not depend on h5py, so this module gives it the names it calls, with
h5py's behaviour, for the part of HDF5 that ``pack_to_hdf`` writes and
``HDFDataset`` reads:

- one root group, with scalar attributes (integers, floats, UTF-8 strings);
- datasets of fixed-point or IEEE floating-point numbers, or of
  variable-length strings (``string_dtype()``), stored contiguous;
- ``File(path, "r" | "w")``, ``file.attrs``, ``file[name]``, ``name in
  file``, ``create_dataset(name, data=, dtype=, compression=None)``,
  ``dataset[i]``, ``dataset[:]``, ``.dtype``, ``.shape``; and, beyond
  h5py, ``dataset.read_rows_into``, which reads rows straight into a
  caller's buffer (``data/gather.py``'s training batches).

The writer lays files out as the HDF5 library does for h5py's defaults
(superblock version 0, version-1 object headers, a symbol-table root group,
global heap collections of at least 4096 bytes for the strings), so h5py
reads them; the reader reads what h5py writes with those defaults. A file
that needs more (chunked or compressed storage, nested groups, other
types) raises ``NotImplementedError``.
"""

from __future__ import annotations

import os
import struct
from typing import Any

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
_SIG = b"\x89HDF\r\n\x1a\n"
_FREE_NULL = 1  # the end of a local heap's free list
_GCOL_MIN = 4096
_GCOL_MAX_OBJECTS = 65_000
# a variable-length element: its length, its global heap collection, its index there
_VLEN = np.dtype([("len", "<u4"), ("addr", "<u8"), ("idx", "<u4")])


def string_dtype(encoding: str = "utf-8", length: int | None = None) -> np.dtype:
    """A variable-length UTF-8 string type, as h5py's ``string_dtype``."""
    if encoding != "utf-8" or length is not None:
        raise NotImplementedError("only variable-length UTF-8 strings are supported")
    return np.dtype("O", metadata={"vlen": str})


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ------------------------------------------------------------------ reading
def _parse_dtype(b: bytes) -> tuple[Any, int]:
    """A datatype message → (numpy dtype, or "vlen_str"; its size)."""
    cls, bits0, bits1 = b[0] & 0x0F, b[1], b[2]
    size = struct.unpack_from("<I", b, 4)[0]
    order = ">" if bits0 & 1 else "<"
    if cls == 0:
        return np.dtype(f"{order}{'i' if bits0 & 0x08 else 'u'}{size}"), size
    if cls == 1:
        return np.dtype(f"{order}f{size}"), size
    if cls == 9 and (bits0 & 0x0F) == 1:
        return "vlen_str", size
    raise NotImplementedError(f"HDF5 datatype class {cls} is not supported")


def _parse_space(b: bytes) -> tuple[int, ...]:
    if b[0] != 1:
        raise NotImplementedError(f"HDF5 dataspace version {b[0]}")
    rank = b[1]
    return struct.unpack_from(f"<{rank}Q", b, 8) if rank else ()


class _Reader:
    def __init__(self, path: str) -> None:
        self.fd = os.open(path, os.O_RDONLY)
        self._gcol: dict[int, dict[int, bytes]] = {}

    def read(self, offset: int, n: int) -> bytes:
        out = os.pread(self.fd, n, offset)
        if len(out) != n:
            raise ValueError(f"truncated HDF5 file: wanted {n} bytes at {offset}")
        return out

    def messages(self, addr: int) -> list[tuple[int, bytes]]:
        """(type, data) of every message of the object header at ``addr``."""
        head = self.read(addr, 16)
        if head[0] != 1:
            raise NotImplementedError(f"HDF5 object header version {head[0]}")
        nmsgs, size = struct.unpack_from("<H", head, 2)[0], struct.unpack_from("<I", head, 8)[0]
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < nmsgs:
            start, length = blocks.pop(0)
            data, p = self.read(start, length), 0
            while p + 8 <= length and len(out) < nmsgs:
                mtype, msize = struct.unpack_from("<HH", data, p)
                body = data[p + 8:p + 8 + msize]
                if mtype == 0x10:  # continuation
                    blocks.append(struct.unpack_from("<QQ", body))
                out.append((mtype, body))
                p += 8 + msize
        return out

    def heap_object(self, addr: int, index: int) -> bytes:
        if addr not in self._gcol:
            head = self.read(addr, 16)
            if head[:4] != b"GCOL":
                raise ValueError(f"no global heap collection at {addr}")
            size = struct.unpack_from("<Q", head, 8)[0]
            data, p, objs = self.read(addr, size), 16, {}
            while p + 16 <= size:
                idx = struct.unpack_from("<H", data, p)[0]
                osize = struct.unpack_from("<Q", data, p + 8)[0]
                if idx == 0:
                    break
                objs[idx] = data[p + 16:p + 16 + osize]
                p += 16 + _pad8(osize)
            self._gcol[addr] = objs
        return self._gcol[addr][index]

    def vlen_strings(self, raw: bytes, n: int) -> list[bytes]:
        desc = np.frombuffer(raw, dtype=_VLEN, count=n).tolist()
        return [self.heap_object(a, i)[:ln] if ln else b"" for ln, a, i in desc]

    def close(self) -> None:
        os.close(self.fd)


def _attribute(reader: _Reader, b: bytes) -> tuple[str, Any]:
    if b[0] != 1:
        raise NotImplementedError(f"HDF5 attribute message version {b[0]}")
    name_size, type_size, space_size = struct.unpack_from("<HHH", b, 2)
    p = 8
    name = b[p:p + name_size].rstrip(b"\0").decode()
    p += _pad8(name_size)
    dtype, size = _parse_dtype(b[p:p + type_size])
    p += _pad8(type_size)
    shape = _parse_space(b[p:p + space_size])
    p += _pad8(space_size)
    n = int(np.prod(shape)) if shape else 1
    raw = b[p:p + n * size]
    if dtype == "vlen_str":
        values = [s.decode() for s in reader.vlen_strings(raw, n)]
        value = values[0] if not shape else np.array(values, dtype=object).reshape(shape)
    else:
        arr = np.frombuffer(raw, dtype=dtype, count=n).reshape(shape)
        value = arr[()] if not shape else arr.copy()
    return name, value


class Dataset:
    """A contiguous dataset: ``ds[i]`` reads one row, ``ds[:]`` all of it."""

    def __init__(self, reader: _Reader, messages: list[tuple[int, bytes]]) -> None:
        self._reader = reader
        for mtype, body in messages:
            if mtype == 0x01:
                self.shape = tuple(int(s) for s in _parse_space(body))
            elif mtype == 0x03:
                self._type, self._size = _parse_dtype(body)
            elif mtype == 0x08:
                if body[0] != 3 or body[1] != 1:
                    raise NotImplementedError("only contiguous HDF5 datasets are supported")
                self._addr = struct.unpack_from("<Q", body, 2)[0]
        self._row_items = int(np.prod(self.shape[1:]))

    @property
    def dtype(self) -> np.dtype:
        return string_dtype() if self._type == "vlen_str" else self._type

    def __len__(self) -> int:
        return self.shape[0]

    def _raw(self, first: int, count: int) -> bytes:
        row = self._row_items * self._size
        if self._addr == UNDEF:  # never written: the fill value, zeros
            return bytes(count * row)
        return self._reader.read(self._addr + first * row, count * row)

    def _values(self, first: int, count: int) -> np.ndarray:
        n = count * self._row_items
        raw = self._raw(first, count)
        if self._type == "vlen_str":
            out = np.empty(n, dtype=object)
            out[:] = self._reader.vlen_strings(raw, n)
        else:
            out = np.frombuffer(raw, dtype=self._type, count=n).copy()
        return out.reshape((count,) + self.shape[1:])

    def read_rows_into(self, rows: list[int], items: list[int], dest: memoryview,
                       offsets: list[int]) -> None:
        """Read the first ``items[i]`` elements of row ``rows[i]`` straight
        into the bytes ``dest`` at ``offsets[i]``: one ``os.preadv`` a row,
        which runs without the GIL. A dataset never written reads as zeros."""
        if self._type == "vlen_str":
            raise NotImplementedError("rows of strings are not read into a buffer")
        row, fd = self._row_items * self._size, self._reader.fd
        for r, n, o in zip(rows, items, offsets):
            nbytes = n * self._size
            view = dest[o:o + nbytes]
            if self._addr == UNDEF:
                view[:] = bytes(nbytes)
            elif os.preadv(fd, [view], self._addr + r * row) != nbytes:
                raise ValueError(f"truncated HDF5 file: wanted {nbytes} bytes of row {r}")

    def __getitem__(self, idx: Any) -> Any:
        if isinstance(idx, (int, np.integer)):
            i = int(idx) + (self.shape[0] if idx < 0 else 0)
            if not 0 <= i < self.shape[0]:
                raise IndexError(f"index {idx} out of range for {self.shape[0]} rows")
            return self._values(i, 1)[0]
        if isinstance(idx, slice):
            start, stop, step = idx.indices(self.shape[0])
            return self._values(start, max(stop - start, 0))[::step]
        raise NotImplementedError(f"unsupported index {idx!r}")


class File:
    """An HDF5 file with one root group, for reading (``"r"``) or for
    writing anew (``"w"``; the file is written on ``close``)."""

    def __init__(self, path: str, mode: str = "r") -> None:
        if mode not in ("r", "w"):
            raise NotImplementedError(f"mode {mode!r} (only 'r' and 'w')")
        self.filename, self.mode = path, mode
        self.attrs: dict[str, Any] = {}
        self._datasets: dict[str, Any] = {}
        self._reader = None
        if mode == "r":
            self._open()

    def _open(self) -> None:
        r = self._reader = _Reader(self.filename)
        sb = r.read(0, 96)
        if sb[:8] != _SIG:
            raise OSError(f"{self.filename!r} is not an HDF5 file")
        if sb[8] != 0 or sb[13] != 8 or sb[14] != 8:
            raise NotImplementedError("only version-0 superblocks with 8-byte offsets are supported")
        root = struct.unpack_from("<Q", sb, 64)[0]
        btree = heap = None
        for mtype, body in r.messages(root):
            if mtype == 0x11:
                btree, heap = struct.unpack_from("<QQ", body)
            elif mtype == 0x0C:
                k, v = _attribute(r, body)
                self.attrs[k] = v
        if btree is None:
            raise NotImplementedError("only symbol-table root groups are supported")
        hh = r.read(heap, 32)
        if hh[:4] != b"HEAP":
            raise ValueError("no local heap for the root group")
        hsize, _, haddr = struct.unpack_from("<QQQ", hh, 8)
        names = r.read(haddr, hsize)
        for name_off, header in self._symbols(btree):
            name = names[name_off:names.index(b"\0", name_off)].decode()
            self._datasets[name] = header

    def _symbols(self, node: int) -> list[tuple[int, int]]:
        r = self._reader
        head = r.read(node, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise ValueError(f"no group B-tree node at {node}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        body = r.read(node + 24, 8 + used * 16)
        children = [struct.unpack_from("<Q", body, 8 + 16 * i)[0] for i in range(used)]
        out = []
        for child in children:
            if level > 0:
                out += self._symbols(child)
                continue
            sn = r.read(child, 8)
            if sn[:4] != b"SNOD":
                raise ValueError(f"no symbol table node at {child}")
            count = struct.unpack_from("<H", sn, 6)[0]
            ents = r.read(child + 8, 40 * count)
            out += [struct.unpack_from("<QQ", ents, 40 * i) for i in range(count)]
        return out

    # ------------------------------------------------------------ access
    def __contains__(self, name: str) -> bool:
        return name in self._datasets

    def __getitem__(self, name: str) -> Any:
        if self.mode == "w":
            return self._datasets[name][0]
        value = self._datasets[name]
        if not isinstance(value, Dataset):
            msgs = self._reader.messages(value)
            if any(t == 0x11 for t, _ in msgs):
                raise NotImplementedError(f"{name!r} is a group; only datasets are supported")
            value = self._datasets[name] = Dataset(self._reader, msgs)
        return value

    def create_dataset(self, name: str, data: Any = None, dtype: Any = None,
                       compression: Any = None, **kwargs: Any) -> None:
        if self.mode != "w":
            raise OSError("the file is open for reading")
        if compression is not None or kwargs:
            raise NotImplementedError("compression, chunks and other options are not supported")
        if name in self._datasets or "/" in name:
            raise ValueError(f"cannot create dataset {name!r}")
        vlen = dtype is not None and np.dtype(dtype).metadata is not None \
            and np.dtype(dtype).metadata.get("vlen") is str
        arr = np.asarray(data, dtype=object if vlen else dtype)
        if not vlen and arr.dtype.kind not in "iuf":
            raise NotImplementedError(f"dataset dtype {arr.dtype} is not supported")
        self._datasets[name] = (arr, vlen)

    def close(self) -> None:
        if self.mode == "w" and self._datasets is not None:
            _write(self.filename, dict(self.attrs), self._datasets)
            self._datasets = None
        elif self._reader is not None:
            self._reader.close()
            self._reader = None

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __del__(self) -> None:
        if self.mode == "r" and getattr(self, "_reader", None) is not None:
            self.close()


# ------------------------------------------------------------------ writing
def _dtype_message(dtype: Any) -> bytes:
    if dtype == "vlen_str":
        base = struct.pack("<BBBBIHH", 0x10, 0, 0, 0, 1, 0, 8)
        return struct.pack("<BBBBI", 0x19, 0x01, 0x01, 0, 16) + base
    dt = np.dtype(dtype).newbyteorder("<")
    size = dt.itemsize
    if dt.kind in "iu":
        return struct.pack("<BBBBIHH", 0x10, 0x08 if dt.kind == "i" else 0, 0, 0, size, 0, 8 * size)
    if dt.kind == "f" and size in (4, 8):
        exp_loc, exp_size, mant, bias = (23, 8, 23, 127) if size == 4 else (52, 11, 52, 1023)
        return struct.pack("<BBBBIHHBBBBI", 0x11, 0x20, 8 * size - 1, 0, size, 0, 8 * size,
                           exp_loc, exp_size, 0, mant, bias)
    raise NotImplementedError(f"dtype {dt} is not supported")


def _space_message(shape: tuple[int, ...]) -> bytes:
    return struct.pack("<BBBB4x", 1, len(shape), 0, 0) + struct.pack(f"<{len(shape)}Q", *shape)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    size = _pad8(len(body))
    return struct.pack("<HHB3x", mtype, size, flags) + body.ljust(size, b"\0")


def _object_header(messages: list[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _GlobalHeap:
    """Strings laid out in global heap collections, placed from ``base``."""

    def __init__(self) -> None:
        self.collections: list[list[bytes]] = [[]]

    def add(self, data: bytes) -> tuple[int, int]:
        if len(self.collections[-1]) >= _GCOL_MAX_OBJECTS:
            self.collections.append([])
        self.collections[-1].append(data)
        return len(self.collections) - 1, len(self.collections[-1])

    def sizes(self) -> list[int]:
        out = []
        for objs in self.collections:
            used = 16 + sum(16 + _pad8(len(o)) for o in objs)
            out.append(max(_GCOL_MIN, used + 16))
        return out

    def image(self, index: int, size: int) -> bytes:
        parts = [b"GCOL" + struct.pack("<B3xQ", 1, size)]
        for i, o in enumerate(self.collections[index], start=1):
            parts.append(struct.pack("<HH4xQ", i, 1, len(o)) + o.ljust(_pad8(len(o)), b"\0"))
        used = sum(len(p) for p in parts)
        parts.append(struct.pack("<HH4xQ", 0, 0, size - used))
        return b"".join(parts).ljust(size, b"\0")


def _write(path: str, attrs: dict[str, Any], datasets: dict[str, tuple[np.ndarray, bool]]) -> None:
    heap = _GlobalHeap()
    refs: dict[str, list[tuple[int, int, int]]] = {}

    def strings(key: str, values: list[Any]) -> None:
        encoded = [v if isinstance(v, bytes) else str(v).encode() for v in values]
        refs[key] = [(len(e),) + heap.add(e) for e in encoded]

    attr_items = []
    for name, value in attrs.items():
        if isinstance(value, (str, bytes)):
            strings(f"attr:{name}", [value])
            attr_items.append((name, "vlen_str", ()))
        else:
            arr = np.asarray(value)
            if arr.dtype.kind not in "iuf":
                raise NotImplementedError(f"attribute {name!r} of dtype {arr.dtype}")
            attr_items.append((name, arr, arr.shape))
    names = sorted(datasets)
    for name in names:
        arr, vlen = datasets[name]
        if vlen:
            strings(f"data:{name}", list(arr.reshape(-1)))

    def vlen_bytes(key: str, gcol_addr: list[int]) -> bytes:
        return b"".join(struct.pack("<IQI", n, gcol_addr[c], i) for n, c, i in refs[key])

    # local heap of the names: "" at 0, then each name, then one free block
    heap_data, offsets = bytearray(8), {}
    for name in names:
        offsets[name] = len(heap_data)
        heap_data += name.encode().ljust(_pad8(len(name) + 1), b"\0")
    free_off = len(heap_data)
    heap_data += struct.pack("<QQ", _FREE_NULL, 16)

    leaf_k = max(4, (len(names) + 1) // 2)
    internal_k = 16
    sizes = {
        "sb": 96,
        "btree": 24 + (2 * internal_k + 1) * 8 + 2 * internal_k * 8,
        "lheap": 32,
        "lheap_data": len(heap_data),
        "snod": 8 + 2 * leaf_k * 40,
    }

    def attr_message(name: str, kind: Any, shape: tuple, gaddr: list[int]) -> bytes:
        if kind == "vlen_str":
            dtype_b, data = _dtype_message("vlen_str"), vlen_bytes(f"attr:{name}", gaddr)
        else:
            dtype_b, data = _dtype_message(kind.dtype), kind.astype(kind.dtype.newbyteorder("<")).tobytes()
        space_b, name_b = _space_message(shape), name.encode() + b"\0"
        body = (struct.pack("<BBHHH", 1, 0, len(name_b), len(dtype_b), len(space_b))
                + name_b.ljust(_pad8(len(name_b)), b"\0") + dtype_b.ljust(_pad8(len(dtype_b)), b"\0")
                + space_b.ljust(_pad8(len(space_b)), b"\0") + data)
        return _message(0x0C, body)

    def layout(gaddr: list[int], daddr: dict[str, int], btree: int, lheap: int) -> tuple[bytes, dict]:
        root = _object_header([_message(0x11, struct.pack("<QQ", btree, lheap))]
                              + [attr_message(n, k, s, gaddr) for n, k, s in attr_items])
        headers = {}
        for name in names:
            arr, vlen = datasets[name]
            headers[name] = _object_header([
                _message(0x01, _space_message(arr.shape)),
                _message(0x03, _dtype_message("vlen_str" if vlen else arr.dtype), flags=1),
                _message(0x05, bytes([2, 2, 2, 1, 0, 0, 0, 0]), flags=1),
                _message(0x08, struct.pack("<BBQQ", 3, 1, daddr.get(name, UNDEF),
                                           len(arr.reshape(-1)) * (16 if vlen else arr.dtype.itemsize))),
            ])
        return root, headers

    # two passes: the header sizes do not depend on the addresses
    root0, headers0 = layout([0] * len(heap.collections), {}, 0, 0)
    pos = sizes["sb"]
    addr = {}
    for key in ("root", "btree", "lheap", "lheap_data", "snod"):
        addr[key] = pos
        pos += len(root0) if key == "root" else sizes[key]
    for name in names:
        addr[f"h:{name}"] = pos
        pos += len(headers0[name])
    gaddr, gsizes = [], heap.sizes()
    for size in gsizes:
        gaddr.append(pos)
        pos += size
    daddr = {}  # an empty dataset has no storage: the undefined address
    for name in names:
        arr, vlen = datasets[name]
        if arr.size:
            daddr[name] = pos
            pos += arr.size * (16 if vlen else arr.dtype.itemsize)
    eof = pos
    root, headers = layout(gaddr, daddr, addr["btree"], addr["lheap"])

    sb = (_SIG + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + struct.pack("<HHI", leaf_k, internal_k, 0)
          + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
          + struct.pack("<QQI4xQQ", 0, addr["root"], 1, addr["btree"], addr["lheap"]))
    btree = (b"TREE" + struct.pack("<BBHQQ", 0, 0, 1 if names else 0, UNDEF, UNDEF)
             + struct.pack("<QQQ", 0, addr["snod"], offsets[names[-1]] if names else 0))
    lheap = b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), free_off, addr["lheap_data"])
    snod = b"SNOD" + struct.pack("<BBH", 1, 0, len(names)) + b"".join(
        struct.pack("<QQI4x16x", offsets[n], addr[f"h:{n}"], 0) for n in names)

    with open(path, "wb") as f:
        f.write(sb)
        f.write(root)
        f.write(btree.ljust(sizes["btree"], b"\0"))
        f.write(lheap)
        f.write(bytes(heap_data))
        f.write(snod.ljust(sizes["snod"], b"\0"))
        for name in names:
            f.write(headers[name])
        for i, size in enumerate(gsizes):
            f.write(heap.image(i, size))
        for name in names:
            arr, vlen = datasets[name]
            if vlen:
                f.write(vlen_bytes(f"data:{name}", gaddr))
            else:
                f.write(np.ascontiguousarray(arr, arr.dtype.newbyteorder("<")).tobytes())
        if f.tell() != eof:
            raise AssertionError(f"HDF5 layout error: wrote {f.tell()} bytes, planned {eof}")
