"""Minimal pure-Python LZ4 (frame + block) codec for rosbag chunks (a copy of
`pointcloud_slam_tpu/io/lz4.py`, which cannot be imported without jax).

rosbag's default chunk compression on many robots is lz4; the reference
replays such bags transparently through `rosbag::View`
(`src/jueying_lio/app/run_mapping_offline.cc:46-82` — the compression is
handled inside the rosbag library, by roslz4). roslz4 writes the public
LZ4 *frame* format (magic 0x184D2204, FLG/BD descriptor + header checksum,
independent blocks, optional xxHash32 content checksum); each block is
either stored (high bit of the size word set) or a raw LZ4 *block*
(token / literals / offset+matchlen sequences).

This module implements both layers from the public format specs
(https://github.com/lz4/lz4/blob/dev/doc/lz4_Frame_format.md and
lz4_Block_format.md) — no instruction-following from the reference, just
wire-format compatibility. The decoder is correctness-first Python (the
fast path for big bags is the native C++ reader, native/src/bagreader.cpp,
which carries the same logic in C); the compressor is a simple greedy
hash-chain matcher used for fixtures, tests and `BagWriter` output.
"""

from __future__ import annotations

import struct

MAGIC = 0x184D2204

# ------------------------------------------------------------------ xxHash32
# needed for the frame descriptor's header-checksum byte (HC = byte 1 of
# xxh32(descriptor)) and the optional content checksum

_P1, _P2, _P3, _P4, _P5 = 2654435761, 2246822519, 3266489917, 668265263, 374761393
_M = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def xxh32(data: bytes, seed: int = 0) -> int:
    n = len(data)
    o = 0
    if n >= 16:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed
        v4 = (seed - _P1) & _M
        while o + 16 <= n:
            for i, v in enumerate((v1, v2, v3, v4)):
                (lane,) = struct.unpack_from("<I", data, o + 4 * i)
                v = (v + lane * _P2) & _M
                v = (_rotl(v, 13) * _P1) & _M
                if i == 0:
                    v1 = v
                elif i == 1:
                    v2 = v
                elif i == 2:
                    v3 = v
                else:
                    v4 = v
            o += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
    else:
        h = (seed + _P5) & _M
    h = (h + n) & _M
    while o + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, o)
        h = (h + lane * _P3) & _M
        h = (_rotl(h, 17) * _P4) & _M
        o += 4
    while o < n:
        h = (h + data[o] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        o += 1
    h ^= h >> 15
    h = (h * _P2) & _M
    h ^= h >> 13
    h = (h * _P3) & _M
    h ^= h >> 16
    return h


# ------------------------------------------------------------------- block

def block_decompress(src: bytes) -> bytes:
    """Decode one raw LZ4 block (token/literals/match sequences).

    Every read is bounds-checked: truncated or corrupt input raises instead
    of silently returning short data (Python slices truncate quietly — the
    C++ twin in native/src/bagreader.cpp returns false on the same checks)."""
    out = bytearray()
    n = len(src)
    o = 0
    while o < n:
        token = src[o]
        o += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if o >= n:
                    raise ValueError("lz4 block: truncated literal length")
                b = src[o]
                o += 1
                lit += b
                if b != 255:
                    break
        if o + lit > n:
            raise ValueError("lz4 block: literal run overruns input")
        out += src[o : o + lit]
        o += lit
        if o >= n:
            break  # final sequence carries literals only
        if o + 2 > n:
            raise ValueError("lz4 block: truncated match offset")
        offset = src[o] | (src[o + 1] << 8)
        o += 2
        if offset == 0:
            raise ValueError("lz4 block: zero match offset")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                if o >= n:
                    raise ValueError("lz4 block: truncated match length")
                b = src[o]
                o += 1
                mlen += b
                if b != 255:
                    break
        start = len(out) - offset
        if start < 0:
            raise ValueError("lz4 block: match offset before output start")
        if offset >= mlen:
            out += out[start : start + mlen]
        else:  # overlapping match: byte-wise copy (RLE-style)
            for i in range(mlen):
                out.append(out[start + i])
    return bytes(out)


def _write_varlen(extra: int) -> bytes:
    b = bytearray()
    while extra >= 255:
        b.append(255)
        extra -= 255
    b.append(extra)
    return bytes(b)


def block_compress(src: bytes) -> bytes:
    """Greedy LZ4 block encoder (hash table over 4-byte windows).

    Spec constraints respected: the last 5 bytes are always literals and no
    match starts within the last 12 bytes of the block. Not tuned for ratio
    — it exists so fixtures/tests and BagWriter can emit real compressed
    blocks that exercise the decoders' match paths.
    """
    n = len(src)
    out = bytearray()
    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    limit = n - 12
    while i < limit:
        key = src[i : i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= 0xFFFF and src[cand : cand + 4] == key:
            # extend the match (stop 5 bytes before the end)
            mlen = 4
            mmax = n - 5 - i
            while mlen < mmax and src[cand + mlen] == src[i + mlen]:
                mlen += 1
            lit = src[anchor:i]
            lt = min(len(lit), 15)
            mt = min(mlen - 4, 15)
            out.append((lt << 4) | mt)
            if lt == 15:
                out += _write_varlen(len(lit) - 15)
            out += lit
            out += struct.pack("<H", i - cand)
            if mt == 15:
                out += _write_varlen(mlen - 4 - 15)
            i += mlen
            anchor = i
        else:
            i += 1
    lit = src[anchor:]
    lt = min(len(lit), 15)
    out.append(lt << 4)
    if lt == 15:
        out += _write_varlen(len(lit) - 15)
    out += lit
    return bytes(out)


# ------------------------------------------------------------------- frame

def frame_decompress(src: bytes) -> bytes:
    """Decode an LZ4 frame (the roslz4 wire format for rosbag lz4 chunks)."""
    if len(src) < 7 or struct.unpack_from("<I", src, 0)[0] != MAGIC:
        raise ValueError("not an LZ4 frame (bad magic)")
    o = 4
    flg = src[o]
    bd = src[o + 1]
    if (flg >> 6) != 0b01:
        raise ValueError(f"unsupported LZ4 frame version {flg >> 6}")
    block_checksum = bool(flg & 0x10)
    content_size = bool(flg & 0x08)
    content_checksum = bool(flg & 0x04)
    del bd  # block max size: informational only for decoding
    o += 2
    desc_len = 2 + (8 if content_size else 0)
    if 4 + desc_len + 1 > len(src):
        raise ValueError("truncated LZ4 frame (header)")
    expect_hc = (xxh32(src[4 : 4 + desc_len]) >> 8) & 0xFF
    if content_size:
        o += 8
    hc = src[o]
    o += 1
    if hc != expect_hc:
        raise ValueError("LZ4 frame: header checksum mismatch")
    out = bytearray()
    while True:
        if o + 4 > len(src):
            raise ValueError("truncated LZ4 frame (block header)")
        (word,) = struct.unpack_from("<I", src, o)
        o += 4
        if word == 0:  # EndMark
            break
        size = word & 0x7FFFFFFF
        if o + size > len(src):
            raise ValueError("truncated LZ4 frame (block data)")
        data = src[o : o + size]
        o += size
        if word & 0x80000000:
            out += data  # stored (uncompressed) block
        else:
            out += block_decompress(data)
        if block_checksum:
            if o + 4 > len(src):
                raise ValueError("truncated LZ4 frame (block checksum)")
            (bc,) = struct.unpack_from("<I", src, o)
            o += 4
            if bc != xxh32(data):
                raise ValueError("LZ4 frame: block checksum mismatch")
    if content_checksum:
        if o + 4 > len(src):
            raise ValueError("truncated LZ4 frame (content checksum)")
        (cs,) = struct.unpack_from("<I", src, o)
        if cs != xxh32(bytes(out)):
            raise ValueError("LZ4 frame: content checksum mismatch")
    return bytes(out)


def frame_compress(src: bytes, block_size: int = 1 << 20) -> bytes:
    """Encode an LZ4 frame: independent blocks, content checksum (the same
    descriptor flags roslz4 writes), stored blocks when expansion occurs."""
    if block_size > (4 << 20):
        # BD id 7 (the largest defined) declares a 4 MB block maximum;
        # emitting bigger blocks would produce a spec-violating frame that
        # real liblz4/roslz4 consumers reject
        raise ValueError(f"block_size {block_size} exceeds the 4 MB LZ4 frame maximum")
    flg = (0b01 << 6) | 0x20 | 0x04  # version 01, block-independent, content checksum
    bd = 0x70  # block max size id 7 (4 MB)
    desc = bytes([flg, bd])
    hc = (xxh32(desc) >> 8) & 0xFF
    out = bytearray(struct.pack("<I", MAGIC) + desc + bytes([hc]))
    for o in range(0, len(src), block_size):
        blk = src[o : o + block_size]
        comp = block_compress(blk)
        if len(comp) < len(blk):
            out += struct.pack("<I", len(comp)) + comp
        else:
            out += struct.pack("<I", 0x80000000 | len(blk)) + blk
    out += struct.pack("<I", 0)  # EndMark
    out += struct.pack("<I", xxh32(src))
    return bytes(out)
