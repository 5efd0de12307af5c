"""Clean-room reader for TensorFlow *TensorBundle* checkpoints.

A numpy-only copy of ``deeprec_tpu/checkpoint/bundle_reader.py``, held to
its source by ``tests/test_torch_migrate.py``; the one change is the dtype
table, which has no bfloat16 (the source registers it through
``ml_dtypes``, which the port does not import).

DeepRec persists everything (dense variables and EmbeddingVariable
``-keys/-values/-versions/-freqs`` quads) through ``BundleWriter``. The
``.index`` file is a leveldb-style sorted string table whose values are
``BundleEntryProto`` messages, and the ``.data-NNNNN-of-MMMMM`` shards hold
raw little-endian tensor bytes at ``[offset, offset+size)``. Here: a
minimal protobuf wire-format decoder, the SSTable block and footer layout,
``OrderedCode`` keys of sliced tensors (partitioned dense variables are
stitched back into full tensors) and masked CRC32C validation.
"""
from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57  # reference: core/lib/io/format.h
FOOTER_LEN = 48                   # 2 max-length BlockHandles (20) + magic

# DataType enum values -> numpy dtypes (reference: core/framework/types.proto)
_DTYPES: Dict[int, np.dtype] = {}
for _code, _np in [
    (1, np.float32), (2, np.float64), (3, np.int32), (4, np.uint8),
    (5, np.int16), (6, np.int8), (8, np.complex64), (9, np.int64),
    (10, np.bool_), (17, np.uint16), (18, np.complex128), (19, np.float16),
    (22, np.uint32), (23, np.uint64),
]:
    _DTYPES[_code] = np.dtype(_np)
# DT_BFLOAT16 (14) is left out: numpy has no bfloat16 without ml_dtypes,
# which this package does not import; such a tensor raises in ``dtype``.
DT_STRING = 7


# ---------------------------------------------------------------------------
# protobuf wire format (decode only)


def _uvarint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _as_int64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) from a serialized message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _uvarint(buf, pos)
        fnum, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _uvarint(buf, pos)
        elif wt == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _uvarint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:  # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fnum, wt, val


def _parse_shape(buf: bytes) -> Optional[Tuple[int, ...]]:
    """TensorShapeProto: dim=2 (Dim.size=1), unknown_rank=3."""
    dims: List[int] = []
    unknown = False
    for fnum, _, val in _fields(buf):
        if fnum == 2:
            size = 0
            for dfn, _, dval in _fields(val):
                if dfn == 1:
                    size = _as_int64(dval)
            dims.append(size)
        elif fnum == 3 and val:
            unknown = True
    return None if unknown else tuple(dims)


@dataclasses.dataclass
class SliceExtent:
    start: int
    length: int  # -1 = full extent (TensorSlice::kFullExtent)


def _parse_slice(buf: bytes) -> List[SliceExtent]:
    """TensorSliceProto: extent=1 (Extent.start=1, Extent.length=2)."""
    extents = []
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            start, length = 0, -1
            for efn, _, eval_ in _fields(val):
                if efn == 1:
                    start = _as_int64(eval_)
                elif efn == 2:
                    length = _as_int64(eval_)
            extents.append(SliceExtent(start, length))
    return extents


@dataclasses.dataclass
class BundleEntry:
    """BundleEntryProto: dtype=1, shape=2, shard_id=3, offset=4, size=5,
    crc32c=6 (fixed32), slices=7 (reference: protobuf/tensor_bundle.proto).
    """
    dtype_code: int = 0
    shape: Optional[Tuple[int, ...]] = None
    shard_id: int = 0
    offset: int = 0
    size: int = 0
    crc32c: int = 0
    slices: List[List[SliceExtent]] = dataclasses.field(default_factory=list)


def _parse_entry(buf: bytes) -> BundleEntry:
    e = BundleEntry()
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            e.dtype_code = val
        elif fnum == 2:
            e.shape = _parse_shape(val)
        elif fnum == 3:
            e.shard_id = _as_int64(val)
        elif fnum == 4:
            e.offset = _as_int64(val)
        elif fnum == 5:
            e.size = _as_int64(val)
        elif fnum == 6:
            e.crc32c = val
        elif fnum == 7:
            e.slices.append(_parse_slice(val))
    return e


def _parse_header(buf: bytes) -> Dict[str, int]:
    """BundleHeaderProto: num_shards=1, endianness=2 (0=little)."""
    h = {"num_shards": 1, "endianness": 0}
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            h["num_shards"] = _as_int64(val)
        elif fnum == 2:
            h["endianness"] = val
    return h


# ---------------------------------------------------------------------------
# SSTable (leveldb table format, as written by core/lib/io/table_builder.cc)


def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Return the raw (uncompressed) block body, checking the 5-byte
    trailer: 1-byte compression type + masked crc32c of the body."""
    body = data[offset:offset + size]
    ctype = data[offset + size]
    if ctype != 0:  # kNoCompression — BundleWriter forces it (:379)
        raise ValueError(
            f"compressed table block (type={ctype}) unsupported; "
            "TensorBundle index files are written uncompressed")
    return body


def _block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Prefix-compressed entries; the block ends with a uint32 restart
    array and its count (reference: core/lib/io/block_builder.cc header
    comment: shared/non_shared/value_len varints + key delta + value)."""
    if len(block) < 4:
        return
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 * (n_restarts + 1)
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _uvarint(block, pos)
        non_shared, pos = _uvarint(block, pos)
        value_len, pos = _uvarint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        value = block[pos:pos + value_len]
        pos += value_len
        yield key, value


def _parse_table(data: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Iterate every key/value in a leveldb-format table file."""
    if len(data) < FOOTER_LEN:
        raise ValueError("index file too short to hold a table footer")
    footer = data[-FOOTER_LEN:]
    magic = struct.unpack_from("<Q", footer, FOOTER_LEN - 8)[0]
    if magic != TABLE_MAGIC:
        raise ValueError(
            f"bad table magic {magic:#x} (not a TensorBundle index?)")
    pos = 0
    _mi_off, pos = _uvarint(footer, pos)   # metaindex handle (unused)
    _mi_sz, pos = _uvarint(footer, pos)
    ix_off, pos = _uvarint(footer, pos)    # index-block handle
    ix_sz, pos = _uvarint(footer, pos)
    index_block = _read_block(data, ix_off, ix_sz)
    for _sep_key, handle in _block_entries(index_block):
        hpos = 0
        b_off, hpos = _uvarint(handle, hpos)
        b_sz, hpos = _uvarint(handle, hpos)
        yield from _block_entries(_read_block(data, b_off, b_sz))


# ---------------------------------------------------------------------------
# OrderedCode (encode only — for sliced-tensor key lookups)
# reference: core/lib/strings/ordered_code.cc


def _oc_write_string(out: bytearray, s: bytes) -> None:
    # escape \x00 -> \x00\xff and \xff -> \xff\x00, terminate with \x00\x01
    for b in s:
        if b == 0x00:
            out += b"\x00\xff"
        elif b == 0xFF:
            out += b"\xff\x00"
        else:
            out.append(b)
    out += b"\x00\x01"


def _oc_write_num_increasing(out: bytearray, val: int) -> None:
    # single length byte + big-endian significant bytes
    payload = b""
    while val > 0:
        payload = bytes([val & 0xFF]) + payload
        val >>= 8
    out.append(len(payload))
    out += payload


_OC_HEADER_BITS = [  # kLengthToHeaderBits
    (0x00, 0x00), (0x80, 0x00), (0xC0, 0x00), (0xE0, 0x00), (0xF0, 0x00),
    (0xF8, 0x00), (0xFC, 0x00), (0xFE, 0x00), (0xFF, 0x00), (0xFF, 0x80),
    (0xFF, 0xC0),
]
_OC_BITS_TO_LEN = [
    1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 4,
    4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 7,
    7, 7, 7, 7, 7, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 10,
]


def _oc_write_signed_num_increasing(out: bytearray, val: int) -> None:
    x = ~val if val < 0 else val
    if x < 64:
        out.append((0x80 ^ val) & 0xFF)
        return
    length = _OC_BITS_TO_LEN[x.bit_length()]  # Log2Floor64(x) + 1
    sign = 0xFF if val < 0 else 0x00
    buf = bytearray([sign, sign]) + (val & ((1 << 64) - 1)).to_bytes(8, "big")
    begin = bytearray(buf[10 - length:])
    h0, h1 = _OC_HEADER_BITS[length]
    begin[0] ^= h0
    begin[1] ^= h1
    out += begin


def encode_slice_key(name: str, extents: Sequence[SliceExtent]) -> bytes:
    """Key under which a tensor slice's own BundleEntryProto is stored
    (reference: core/util/saved_tensor_slice_util.cc:28
    EncodeTensorNameSlice — leading 0, escaped name, rank, then signed
    start/length per dim; full extents encode start=0, length=-1)."""
    out = bytearray()
    _oc_write_num_increasing(out, 0)
    _oc_write_string(out, name.encode())
    _oc_write_num_increasing(out, len(extents))
    for e in extents:
        _oc_write_signed_num_increasing(out, e.start)
        _oc_write_signed_num_increasing(out, e.length)
    return bytes(out)


# ---------------------------------------------------------------------------
# masked CRC32C (Castagnoli), as used for tensor payloads


def _crc32c_table() -> np.ndarray:
    poly = 0x82F63B78  # reversed Castagnoli polynomial
    table = np.empty(256, np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table[i] = crc
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in memoryview(data):
        crc = (crc >> 8) ^ int(table[(crc ^ b) & 0xFF])
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the reader


class BundleReader:
    """Read tensors from a TensorBundle checkpoint ``prefix`` (the path you
    would hand to ``tf.train.load_checkpoint`` — e.g. ``.../model.ckpt-100``
    with ``model.ckpt-100.index`` next to its data shards)."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        index_path = prefix + ".index"
        if not os.path.isfile(index_path):
            raise FileNotFoundError(index_path)
        with open(index_path, "rb") as f:
            data = f.read()
        self.header = {"num_shards": 1, "endianness": 0}
        self._entries: Dict[bytes, BundleEntry] = {}
        for key, value in _parse_table(data):
            if key == b"":  # kHeaderEntryKey (tensor_bundle.cc:62)
                self.header = _parse_header(value)
            else:
                self._entries[key] = _parse_entry(value)
        if self.header["endianness"] != 0:
            raise ValueError("big-endian bundles are unsupported")

    # -- catalogue ---------------------------------------------------------

    def keys(self) -> List[str]:
        """Plain (non-slice) tensor names, sorted."""
        out = []
        for k in self._entries:
            if not k.startswith(b"\x00"):  # slice keys start with OC 0
                out.append(k.decode())
        return sorted(out)

    def has_tensor(self, name: str) -> bool:
        return name.encode() in self._entries

    def entry(self, name: str) -> BundleEntry:
        try:
            return self._entries[name.encode()]
        except KeyError:
            raise KeyError(f"tensor {name!r} not in bundle "
                           f"{self.prefix!r}") from None

    def dtype(self, name: str) -> np.dtype:
        code = self.entry(name).dtype_code
        if code == DT_STRING:
            raise NotImplementedError(
                f"{name!r} is a DT_STRING tensor; only numeric tensors are "
                "supported (EV state and dense weights are numeric)")
        if code not in _DTYPES:
            raise NotImplementedError(f"{name!r}: unsupported dtype enum "
                                      f"{code}")
        return _DTYPES[code]

    def shape(self, name: str) -> Tuple[int, ...]:
        shape = self.entry(name).shape
        if shape is None:
            raise ValueError(f"{name!r} has unknown rank")
        return shape

    # -- data --------------------------------------------------------------

    def _shard_path(self, shard_id: int) -> str:
        return (f"{self.prefix}.data-{shard_id:05d}"
                f"-of-{self.header['num_shards']:05d}")

    def _read_raw(self, entry: BundleEntry, validate: bool) -> bytes:
        with open(self._shard_path(entry.shard_id), "rb") as f:
            f.seek(entry.offset)
            raw = f.read(entry.size)
        if len(raw) != entry.size:
            raise IOError("short read from bundle data shard")
        if validate and masked_crc32c(raw) != entry.crc32c:
            raise IOError("tensor payload failed crc32c validation")
        return raw

    def get_tensor(self, name: str, validate: bool = False) -> np.ndarray:
        """Materialise a full tensor, stitching partitioned saves
        (``slices``) back together when present."""
        entry = self.entry(name)
        dtype = self.dtype(name)
        shape = self.shape(name)
        if entry.slices:
            full = np.zeros(shape, dtype)
            for extents in entry.slices:
                skey = encode_slice_key(name, extents)
                try:
                    sentry = self._entries[skey]
                except KeyError:
                    raise KeyError(
                        f"slice entry missing for {name!r} "
                        f"extents={extents}") from None
                raw = self._read_raw(sentry, validate)
                index = tuple(
                    slice(e.start,
                          None if e.length < 0 else e.start + e.length)
                    for e in extents)
                region = full[index]
                full[index] = np.frombuffer(raw, dtype).reshape(region.shape)
            return full
        raw = self._read_raw(entry, validate)
        return np.frombuffer(raw, dtype).reshape(shape)
