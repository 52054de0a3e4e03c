"""Zstandard frames (RFC 8878) in Python and NumPy: a whole decoder and a
raw-block encoder.

Orbax checkpoints compress twice with zstd: the OCDBT store's manifests and
B+tree nodes, and every zarr v2 chunk (``{"id": "zstd", "level": 1}``).
:func:`decompress` reads any frame a conforming encoder writes, without a
dictionary: raw, RLE and compressed blocks; raw, RLE, Huffman (one or four
streams, weights direct or FSE-coded) and treeless literals; predefined,
RLE, FSE and repeat tables for the three sequence codes; every frame-header
variant; skippable frames; the XXH64 content checksum. A frame that breaks
the format raises :class:`ZstdError`; nothing is returned half-decoded.
:func:`compress_raw` writes raw blocks only, which any zstd reader takes.

Bit streams are read backward through ``_Bits``: ``words[i]`` is the
little-endian 64-bit word at byte ``i``, so reading ``n <= 56`` bits below
bit position ``pos`` is one shift and mask.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

MAGIC = 0xFD2FB528
_SKIPPABLE_MASK, _SKIPPABLE = 0xFFFFFFF0, 0x184D2A50
BLOCK_MAX = 128 * 1024


class ZstdError(ValueError):
    """A frame that is corrupt, truncated, or uses what this decoder refuses
    (a dictionary)."""


# --- XXH64 -----------------------------------------------------------------

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def _merge(acc: int, v: int) -> int:
    return (((acc ^ _round(0, v)) * _P1) + _P4) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``; a zstd frame's checksum is its low 32 bits."""
    n, i = len(data), 0
    if n >= 32:
        v1, v2 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64
        v3, v4 = seed & _M64, (seed - _P1) & _M64
        stripes = n // 32 * 32
        lanes = np.frombuffer(data, "<u8", stripes // 8).tolist()
        for j in range(0, len(lanes), 4):
            v1, v2 = _round(v1, lanes[j]), _round(v2, lanes[j + 1])
            v3, v4 = _round(v3, lanes[j + 2]), _round(v4, lanes[j + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
        i = stripes
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# --- bit streams -----------------------------------------------------------

def _words(data: bytes) -> List[int]:
    """The little-endian 64-bit word at every byte offset of ``data``."""
    padded = np.frombuffer(bytes(data) + bytes(8), np.uint8)
    return np.ndarray((len(data),), "<u8", padded, 0, (1,)).tolist()


class _Bits:
    """A backward bit stream: the last byte's top set bit marks its end, and
    bits are consumed from there toward bit 0 of the first byte."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("bit stream without its end mark")
        self.words = _words(data)
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        """The next ``n`` bits; past bit 0 the stream reads as zeros and
        ``pos`` goes negative (an overflow the caller tests)."""
        pos = self.pos - n
        self.pos = pos
        if pos >= 0:
            return (self.words[pos >> 3] >> (pos & 7)) & ((1 << n) - 1)
        if pos + n <= 0:
            return 0
        return (self.words[0] & ((1 << (pos + n)) - 1)) << -pos


class _Forward:
    """A forward bit stream from byte ``start`` (FSE table descriptions)."""

    def __init__(self, data: bytes, start: int):
        self.data, self.start, self.bit = data, start, 0

    def peek(self, n: int) -> int:
        b = self.start + (self.bit >> 3)
        chunk = int.from_bytes(self.data[b:b + 8], "little")
        return (chunk >> (self.bit & 7)) & ((1 << n) - 1)

    def skip(self, n: int):
        self.bit += n
        if self.start + ((self.bit + 7) >> 3) > len(self.data):
            raise ZstdError("FSE table description runs past its block")

    def end(self) -> int:
        return self.start + ((self.bit + 7) >> 3)


# --- FSE -------------------------------------------------------------------

class _Fse:
    """A decoding table: per state its symbol, bit count and base."""
    __slots__ = ("log", "sym", "nb", "base")

    def __init__(self, log: int, sym: List[int], nb: List[int], base: List[int]):
        self.log, self.sym, self.nb, self.base = log, sym, nb, base


def _fse_table(norm: List[int], log: int) -> _Fse:
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(norm)
    for s, p in enumerate(norm):
        if p == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = p
    step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, p in enumerate(norm):
        for _ in range(max(p, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE distribution does not fill its table")
    nb, base = [0] * size, [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] += 1
        nb[u] = log - (x.bit_length() - 1)
        base[u] = (x << nb[u]) - size
    return _Fse(log, sym, nb, base)


def _read_fse_description(data: bytes, start: int, max_log: int,
                          max_symbol: int) -> Tuple[_Fse, int]:
    """An FSE table description at ``data[start:]``; returns the table and
    the offset just past it (RFC 8878 4.1.1)."""
    bits = _Forward(data, start)
    log = bits.peek(4) + 5
    bits.skip(4)
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} above {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    norm: List[int] = []
    prev0 = False
    while remaining > 1 and len(norm) <= max_symbol:
        if prev0:
            while True:
                rep = bits.peek(2)
                bits.skip(2)
                norm.extend([0] * rep)
                if rep != 3:
                    break
            if len(norm) > max_symbol:
                raise ZstdError("FSE zero run past the last symbol")
        top = 2 * threshold - 1 - remaining
        low = bits.peek(nbits - 1)
        if low < top:
            count = low
            bits.skip(nbits - 1)
        else:
            count = bits.peek(nbits)
            if count >= threshold:
                count -= top
            bits.skip(nbits)
        count -= 1
        remaining -= abs(count)
        norm.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(norm) > max_symbol + 1:
        raise ZstdError("FSE probabilities do not sum to the table size")
    return _fse_table(norm, log), bits.end()


def _rle_table(symbol: int) -> _Fse:
    return _Fse(0, [symbol], [0], [0])


# RFC 8878 3.1.1.3.2.2: the predefined distributions and the code tables
_LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
               1, 1, 1, 1, 1, -1, -1, -1, -1]
_ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
               -1]
_OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1]
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
                              4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
                                 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
# (max accuracy log, max symbol, predefined distribution and its log) for
# literal lengths, offsets and match lengths, in the modes byte's order
_KINDS = ((9, 35, _LL_DEFAULT, 6), (8, 31, _OF_DEFAULT, 5), (9, 52, _ML_DEFAULT, 6))
_PREDEFINED = tuple(_fse_table(norm, log) for _, _, norm, log in _KINDS)


# --- Huffman ---------------------------------------------------------------

class _Huffman:
    """A lookup table of ``1 << max_bits`` entries, indexed by the next
    ``max_bits`` bits: ``(nb << 8) | symbol``."""
    __slots__ = ("max_bits", "entries")

    def __init__(self, max_bits: int, entries: List[int]):
        self.max_bits, self.entries = max_bits, entries


def _huffman_from_weights(weights: List[int]) -> _Huffman:
    if len(weights) > 255 or any(w > 11 for w in weights):
        raise ZstdError("Huffman weights out of range")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman weights all zero")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if left & (left - 1):
        raise ZstdError("Huffman weights leave no power of two for the last symbol")
    weights = weights + [left.bit_length()]
    if max_bits > 11:
        raise ZstdError(f"Huffman code length {max_bits} above 11")
    ones = weights.count(1)
    if ones < 2 or ones & 1:
        raise ZstdError("Huffman tree with an odd count of weight-1 symbols")
    entries: List[int] = []
    for w in range(1, max_bits + 1):
        entry = ((max_bits + 1 - w) << 8)
        for s, ws in enumerate(weights):
            if ws == w:
                entries.extend([entry | s] * (1 << (w - 1)))
    return _Huffman(max_bits, entries)


def _read_huffman_description(data: bytes, start: int) -> Tuple[_Huffman, int]:
    """A Huffman tree description at ``data[start]`` (RFC 8878 4.2.1)."""
    if start >= len(data):
        raise ZstdError("truncated Huffman tree description")
    head = data[start]
    if head >= 128:
        n = head - 127
        end = start + 1 + (n + 1) // 2
        if end > len(data):
            raise ZstdError("truncated Huffman weights")
        packed = data[start + 1:end]
        weights = [(packed[i >> 1] >> (4 if i % 2 == 0 else 0)) & 15 for i in range(n)]
        return _huffman_from_weights(weights), end
    end = start + 1 + head
    if head == 0 or end > len(data):
        raise ZstdError("truncated FSE-coded Huffman weights")
    fse, stream_start = _read_fse_description(data[:end], start + 1, 6, 255)
    bits = _Bits(data[stream_start:end])
    sym, nb, base = fse.sym, fse.nb, fse.base
    s1, s2 = bits.read(fse.log), bits.read(fse.log)
    weights: List[int] = []
    while True:
        # the two states take turns; the stream ends when an update reads
        # past its first bit, and the other state then gives the last weight
        weights.append(sym[s1])
        s1 = base[s1] + bits.read(nb[s1])
        if bits.pos < 0:
            weights.append(sym[s2])
            break
        weights.append(sym[s2])
        s2 = base[s2] + bits.read(nb[s2])
        if bits.pos < 0:
            weights.append(sym[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    return _huffman_from_weights(weights), end


def _huffman_stream(table: _Huffman, data: bytes, count: int, out: bytearray):
    bits = _Bits(data)
    words, entries, mb = bits.words, table.entries, table.max_bits
    mask, pos, append = (1 << mb) - 1, bits.pos, out.append
    done = 0
    for done in range(count):
        start = pos - mb
        if start < 0:
            break
        e = entries[(words[start >> 3] >> (start & 7)) & mask]
        append(e & 255)
        pos -= e >> 8
    else:
        done = count
    for _ in range(count - done):  # the last symbols: below bit 0 reads zeros
        e = entries[((words[0] & ((1 << pos) - 1)) << (mb - pos)) & mask if pos > 0 else 0]
        append(e & 255)
        pos -= e >> 8
    if pos != 0:
        raise ZstdError("Huffman stream not consumed exactly")


# --- blocks ----------------------------------------------------------------

class _FrameState:
    """What carries from block to block within one frame."""

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables: List[Optional[_Fse]] = [None, None, None]
        self.reps = [1, 4, 8]


def _literals(block: bytes, state: _FrameState) -> Tuple[bytes, int]:
    """The literals section: the regenerated literals and the offset of the
    sequences section."""
    b0 = block[0]
    kind, size_format = b0 & 3, (b0 >> 2) & 3
    if kind < 2:  # raw or RLE
        head = (1, 2, 1, 3)[size_format]
        if head > len(block):
            raise ZstdError("truncated literals header")
        v = int.from_bytes(block[:head], "little")
        regen = v >> 3 if head == 1 else v >> 4
        if regen > BLOCK_MAX:
            raise ZstdError("literals larger than a block")
        if kind == 0:
            if head + regen > len(block):
                raise ZstdError("truncated raw literals")
            return block[head:head + regen], head + regen
        if head >= len(block):
            raise ZstdError("truncated RLE literals")
        return bytes([block[head]]) * regen, head + 1
    head = 3 + max(size_format - 1, 0)
    if head > len(block):
        raise ZstdError("truncated literals header")
    v = int.from_bytes(block[:head], "little")
    nbits = {3: 10, 4: 14, 5: 18}[head]
    regen, comp = (v >> 4) & ((1 << nbits) - 1), (v >> (4 + nbits)) & ((1 << nbits) - 1)
    end = head + comp
    if regen > BLOCK_MAX or end > len(block):
        raise ZstdError("compressed literals out of bounds")
    start = head
    if kind == 2:
        state.huffman, start = _read_huffman_description(block[:end], head)
    elif state.huffman is None:
        raise ZstdError("treeless literals without an earlier Huffman table")
    table = state.huffman
    out = bytearray()
    if size_format == 0:
        _huffman_stream(table, block[start:end], regen, out)
        return bytes(out), end
    if start + 6 > end:
        raise ZstdError("truncated jump table")
    sizes = [int.from_bytes(block[start + 2 * i:start + 2 * i + 2], "little") for i in range(3)]
    sizes.append(end - start - 6 - sum(sizes))
    seg = (regen + 3) // 4
    counts = [seg, seg, seg, regen - 3 * seg]
    if sizes[3] < 1 or counts[3] < 0:
        raise ZstdError("four-stream literals with inconsistent sizes")
    p = start + 6
    for size, count in zip(sizes, counts):
        _huffman_stream(table, block[p:p + size], count, out)
        p += size
    return bytes(out), end


def _sequence_tables(block: bytes, p: int, state: _FrameState) -> int:
    modes = block[p]
    if modes & 3:
        raise ZstdError("reserved bits set in the sequence modes")
    p += 1
    for k, shift in ((0, 6), (1, 4), (2, 2)):
        mode = (modes >> shift) & 3
        max_log, max_symbol = _KINDS[k][0], _KINDS[k][1]
        if mode == 0:
            state.tables[k] = _PREDEFINED[k]
        elif mode == 1:
            if p >= len(block) or block[p] > max_symbol:
                raise ZstdError("RLE sequence code out of range")
            state.tables[k] = _rle_table(block[p])
            p += 1
        elif mode == 2:
            state.tables[k], p = _read_fse_description(block, p, max_log, max_symbol)
        elif state.tables[k] is None:
            raise ZstdError("repeat sequence table without an earlier table")
    return p


def _block(block: bytes, state: _FrameState, out: bytearray):
    """Decode one compressed block onto ``out``."""
    if not block:
        raise ZstdError("empty compressed block")
    lits, p = _literals(block, state)
    if p >= len(block):
        raise ZstdError("compressed block without its sequences section")
    b0 = block[p]
    if b0 < 128:
        nseq, p = b0, p + 1
    elif b0 < 255:
        if p + 2 > len(block):
            raise ZstdError("truncated sequence count")
        nseq, p = ((b0 - 128) << 8) + block[p + 1], p + 2
    else:
        if p + 3 > len(block):
            raise ZstdError("truncated sequence count")
        nseq, p = block[p + 1] + (block[p + 2] << 8) + 0x7F00, p + 3
    if nseq == 0:
        if p != len(block):
            raise ZstdError("bytes after a block without sequences")
        out += lits
        return
    if p >= len(block):
        raise ZstdError("truncated sequence modes")
    p = _sequence_tables(block, p, state)
    if p >= len(block):
        raise ZstdError("sequences without a bit stream")
    bits = _Bits(block[p:])
    words, pos = bits.words, bits.pos
    ll_t, of_t, ml_t = state.tables
    ll_sym, ll_nb, ll_base = ll_t.sym, ll_t.nb, ll_t.base
    of_sym, of_nb, of_base = of_t.sym, of_t.nb, of_t.base
    ml_sym, ml_nb, ml_base = ml_t.sym, ml_t.nb, ml_t.base

    def read(n):
        nonlocal pos
        pos -= n
        if pos < 0:
            raise ZstdError("sequence bit stream overrun")
        return (words[pos >> 3] >> (pos & 7)) & ((1 << n) - 1)

    ll_s, of_s, ml_s = read(ll_t.log), read(of_t.log), read(ml_t.log)
    rep0, rep1, rep2 = state.reps
    lit_pos, n_lits = 0, len(lits)
    for i in range(nseq):
        of_code, ml_code, ll_code = of_sym[of_s], ml_sym[ml_s], ll_sym[ll_s]
        if of_code > 31:
            raise ZstdError("offset code out of range")
        of_value = (1 << of_code) + read(of_code)
        ml = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        ll = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if of_value > 3:
            rep0, rep1, rep2 = of_value - 3, rep0, rep1
        else:
            idx = of_value - 1 + (ll == 0)
            if idx == 1:
                rep0, rep1 = rep1, rep0
            elif idx == 2:
                rep0, rep1, rep2 = rep2, rep0, rep1
            elif idx == 3:
                rep0, rep1, rep2 = rep0 - 1, rep0, rep1
        offset = rep0
        if i + 1 < nseq:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lit_pos + ll > n_lits:
            raise ZstdError("sequence takes more literals than the block has")
        out += lits[lit_pos:lit_pos + ll]
        lit_pos += ll
        n = len(out)
        if offset < 1 or offset > n:
            raise ZstdError("match offset outside the frame's output")
        start = n - offset
        if offset >= ml:
            out += out[start:start + ml]
        else:  # the match overlaps its own output: repeat the period
            period = out[start:]
            out += (period * (ml // offset + 1))[:ml]
    if pos != 0:
        raise ZstdError("sequence bit stream not consumed exactly")
    state.reps = [rep0, rep1, rep2]
    out += lits[lit_pos:]


def _frame(data: bytes, p: int) -> Tuple[bytes, int]:
    """Decode the frame at ``data[p:]`` (after its magic); returns its
    content and the offset after it."""
    if p >= len(data):
        raise ZstdError("truncated frame header")
    fhd = data[p]
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    p += 1
    window = None
    if not single:
        if p >= len(data):
            raise ZstdError("truncated window descriptor")
        exponent, mantissa = data[p] >> 3, data[p] & 7
        base = 1 << (10 + exponent)
        window = base + (base >> 3) * mantissa
        p += 1
    did_size = (0, 1, 2, 4)[dict_flag]
    if did_size:
        if int.from_bytes(data[p:p + did_size], "little") != 0:
            raise ZstdError("frame needs a dictionary")
        p += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = None
    if fcs_size:
        if p + fcs_size > len(data):
            raise ZstdError("truncated frame content size")
        content_size = int.from_bytes(data[p:p + fcs_size], "little")
        if fcs_size == 2:
            content_size += 256
        p += fcs_size
    if window is None:
        window = content_size
    block_max = min(window, BLOCK_MAX)
    state, out = _FrameState(), bytearray()
    while True:
        if p + 3 > len(data):
            raise ZstdError("truncated block header")
        head = int.from_bytes(data[p:p + 3], "little")
        last, kind, size = head & 1, (head >> 1) & 3, head >> 3
        p += 3
        if kind == 3:
            raise ZstdError("reserved block type")
        if kind == 1:
            if p >= len(data) or size > block_max:
                raise ZstdError("RLE block out of bounds")
            out += bytes([data[p]]) * size
            p += 1
        else:
            if size > block_max or p + size > len(data):
                raise ZstdError("block out of bounds")
            if kind == 0:
                out += data[p:p + size]
            else:
                before = len(out)
                _block(data[p:p + size], state, out)
                if len(out) - before > block_max:
                    raise ZstdError("block decodes past the block maximum")
            p += size
        if last:
            break
    if content_size is not None and len(out) != content_size:
        raise ZstdError(f"frame holds {len(out)} bytes, its header says {content_size}")
    if checksum:
        if p + 4 > len(data):
            raise ZstdError("truncated content checksum")
        if int.from_bytes(data[p:p + 4], "little") != xxh64(bytes(out)) & 0xFFFFFFFF:
            raise ZstdError("content checksum mismatch")
        p += 4
    return bytes(out), p


def decompress(data: bytes) -> bytes:
    """The content of one or more concatenated zstd frames (skippable frames
    skipped)."""
    data = bytes(data)
    parts, p = [], 0
    if not data:
        raise ZstdError("no zstd frame")
    while p < len(data):
        if p + 4 > len(data):
            raise ZstdError("truncated frame magic")
        magic = int.from_bytes(data[p:p + 4], "little")
        p += 4
        if magic & _SKIPPABLE_MASK == _SKIPPABLE:
            if p + 4 > len(data):
                raise ZstdError("truncated skippable frame")
            p += 4 + int.from_bytes(data[p:p + 4], "little")
            if p > len(data):
                raise ZstdError("truncated skippable frame")
            continue
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        content, p = _frame(data, p)
        parts.append(content)
    return b"".join(parts)


def compress_raw(data: bytes) -> bytes:
    """One zstd frame of raw blocks (no compression): single-segment, with
    its content size and no checksum."""
    data = bytes(data)
    n = len(data)
    if n < 256:
        head = bytes([0x20, n])
    elif n < 65536 + 256:
        head = bytes([0x60]) + (n - 256).to_bytes(2, "little")
    elif n < 1 << 32:
        head = bytes([0xA0]) + n.to_bytes(4, "little")
    else:
        head = bytes([0xE0]) + n.to_bytes(8, "little")
    parts = [MAGIC.to_bytes(4, "little"), head]
    starts = range(0, n, BLOCK_MAX) if n else [0]
    for s in starts:
        chunk = data[s:s + BLOCK_MAX]
        last = s + BLOCK_MAX >= n
        parts += [((len(chunk) << 3) | int(last)).to_bytes(3, "little"), chunk]
    return b"".join(parts)
