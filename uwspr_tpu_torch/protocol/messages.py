"""WSPR message packing/unpacking and the type-3 callsign hash table.

Host-side protocol logic (never on the TPU hot path). From-scratch Python
with behavior matched to the reference's helpers class:

- unpack50 / unpackcall / unpackgrid / unpackpfx / unpack_message follow
  lib/helpers.cc:321-590 (types 1/2/3, <...> hash lookups, noprint rules).
- nhash is Bob Jenkins' public-domain lookup3 ``hashlittle`` masked to 15
  bits (lib/helpers.cc:151-319; mask at :316).
- pack_message is the *inverse* (absent from the reference, which leans on
  the external ``wsprsim``; README.md:35-43) so tests can synthesize frames.
- HashTable persists to ``hashtable.txt`` in the reference's "%5d %s" format
  (lib/WSPR_unpacker_impl.cc:82-97,106-118).

The port's own copy of uwspr_tpu/protocol/messages.py (imports pointed
inside uwspr_tpu_torch), held equal to it by tests/test_torch_copies.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

_U32 = 0xFFFFFFFF
_CALL_ALPHABET = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ "


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _U32


def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
    a = (a - c) & _U32; a ^= _rot(c, 4); c = (c + b) & _U32
    b = (b - a) & _U32; b ^= _rot(a, 6); a = (a + c) & _U32
    c = (c - b) & _U32; c ^= _rot(b, 8); b = (b + a) & _U32
    a = (a - c) & _U32; a ^= _rot(c, 16); c = (c + b) & _U32
    b = (b - a) & _U32; b ^= _rot(a, 19); a = (a + c) & _U32
    c = (c - b) & _U32; c ^= _rot(b, 4); b = (b + a) & _U32
    return a, b, c


def _final(a: int, b: int, c: int) -> int:
    c ^= b; c = (c - _rot(b, 14)) & _U32
    a ^= c; a = (a - _rot(c, 11)) & _U32
    b ^= a; b = (b - _rot(a, 25)) & _U32
    c ^= b; c = (c - _rot(b, 16)) & _U32
    a ^= c; a = (a - _rot(c, 4)) & _U32
    b ^= a; b = (b - _rot(a, 14)) & _U32
    c ^= b; c = (c - _rot(b, 24)) & _U32
    return c


def nhash(key: bytes | str, initval: int = 146) -> int:
    """lookup3 hashlittle(key) & 32767 — the WSPR callsign hash."""
    if isinstance(key, str):
        key = key.encode("ascii")
    length = len(key)
    a = b = c = (0xDEADBEEF + length + initval) & _U32
    if length == 0:
        return c & 32767
    # Full 12-byte blocks (all but the last block) are mixed; the final
    # (possibly partial) block is added with zero padding, then finalized.
    pos = 0
    remaining = length
    while remaining > 12:
        blk = key[pos:pos + 12]
        a = (a + int.from_bytes(blk[0:4], "little")) & _U32
        b = (b + int.from_bytes(blk[4:8], "little")) & _U32
        c = (c + int.from_bytes(blk[8:12], "little")) & _U32
        a, b, c = _mix(a, b, c)
        pos += 12
        remaining -= 12
    blk = key[pos:pos + remaining] + b"\x00" * (12 - remaining)
    a = (a + int.from_bytes(blk[0:4], "little")) & _U32
    b = (b + int.from_bytes(blk[4:8], "little")) & _U32
    c = (c + int.from_bytes(blk[8:12], "little")) & _U32
    return _final(a, b, c) & 32767


# ---------------------------------------------------------------------------
# 50-bit payload <-> (n1, n2)
# ---------------------------------------------------------------------------


def unpack50(data: bytes | np.ndarray) -> tuple[int, int]:
    """7+ bytes -> (n1: 28-bit callsign field, n2: 22-bit grid+power field)."""
    if isinstance(data, (bytes, bytearray)):
        d = [int(x) & 255 for x in data[:7]]
    else:
        d = [int(x) & 255 for x in np.asarray(data, dtype=np.uint8)[:7]]
    n1 = (d[0] << 20) | (d[1] << 12) | (d[2] << 4) | ((d[3] >> 4) & 15)
    n2 = ((d[3] & 15) << 18) | (d[4] << 10) | (d[5] << 2) | ((d[6] >> 6) & 3)
    return n1, n2


def pack50(n1: int, n2: int) -> np.ndarray:
    """(n1, n2) -> 11-byte payload (50 info bits followed by zeros)."""
    out = np.zeros(11, dtype=np.uint8)
    out[0] = (n1 >> 20) & 255
    out[1] = (n1 >> 12) & 255
    out[2] = (n1 >> 4) & 255
    out[3] = ((n1 & 15) << 4) | ((n2 >> 18) & 15)
    out[4] = (n2 >> 10) & 255
    out[5] = (n2 >> 2) & 255
    out[6] = (n2 & 3) << 6
    return out


# ---------------------------------------------------------------------------
# Callsign / grid / prefix fields
# ---------------------------------------------------------------------------


def unpack_callsign(ncall: int) -> str | None:
    """28-bit field -> standard callsign, or None if out of range."""
    c = _CALL_ALPHABET
    if ncall >= 262177560:
        return None
    n = ncall
    t5 = c[n % 27 + 10]; n //= 27
    t4 = c[n % 27 + 10]; n //= 27
    t3 = c[n % 27 + 10]; n //= 27
    t2 = c[n % 10]; n //= 10
    t1 = c[n % 36]; n //= 36
    t0 = c[n]
    # reference semantics (helpers.cc:385-396): strip leading spaces, then
    # NUL every remaining space — i.e. the C string TRUNCATES at the first
    # interior space ('AB1 CD' -> 'AB1'), it does not just trim the ends
    return (t0 + t1 + t2 + t3 + t4 + t5).lstrip(" ").split(" ")[0]


def pack_callsign(call: str) -> int:
    """Standard callsign -> 28-bit field (inverse of unpack_callsign)."""
    call = call.upper().strip()
    # Align so the 3rd character is the digit, then pad to 6 with spaces.
    if len(call) < 3 or not call[2].isdigit():
        if len(call) >= 2 and call[1].isdigit():
            call = " " + call
        else:
            raise ValueError(f"cannot align callsign {call!r}")
    if len(call) > 6:
        raise ValueError(
            f"callsign {call.strip()!r} does not fit the 28-bit type-1 field "
            f"(max 3 suffix letters; use a type-2/compound form)")
    call = f"{call:<6s}"
    if not call[2].isdigit():
        raise ValueError(f"third character of {call!r} must be a digit")

    def idx(ch: str) -> int:
        return _CALL_ALPHABET.index(ch)

    def idx27(ch: str) -> int:
        v = idx(ch) - 10
        if not (0 <= v <= 26):
            raise ValueError(f"invalid suffix character {ch!r}")
        return v

    n = idx(call[0])
    n = n * 36 + idx(call[1])
    n = n * 10 + int(call[2])
    n = n * 27 + idx27(call[3])
    n = n * 27 + idx27(call[4])
    n = n * 27 + idx27(call[5])
    return n


def unpack_grid(ngrid_field: int) -> str | None:
    """22-bit n2 field -> 4-char Maidenhead grid, or None if invalid."""
    ngrid = ngrid_field >> 7
    if ngrid >= 32400:
        return None
    c = _CALL_ALPHABET
    dlat = ngrid % 180 - 90
    dlong = (ngrid // 180) * 2 - 180 + 2
    nlong = int(60.0 * (180.0 - dlong) / 5.0)
    g0 = c[10 + nlong // 240]
    g2 = c[(nlong - 240 * (nlong // 240)) // 24]
    nlat = int(60.0 * (dlat + 90) / 2.5)
    g1 = c[10 + nlat // 240]
    g3 = c[(nlat - 240 * (nlat // 240)) // 24]
    return g0 + g1 + g2 + g3


def pack_grid(grid: str) -> int:
    """4-char Maidenhead grid -> ngrid (before the <<7 power shift)."""
    grid = grid.upper()
    if len(grid) != 4 or not (grid[0].isalpha() and grid[1].isalpha()
                              and grid[2].isdigit() and grid[3].isdigit()):
        raise ValueError(f"invalid grid {grid!r}")
    if grid[0] > "R" or grid[1] > "R":
        raise ValueError(f"invalid grid {grid!r}: fields are A-R")
    g0 = ord(grid[0]) - ord("A")
    g1 = ord(grid[1]) - ord("A")
    g2 = int(grid[2])
    g3 = int(grid[3])
    return (179 - 10 * g0 - g2) * 180 + 10 * g1 + g3


def unpack_prefix(nprefix: int, call: str) -> str | None:
    """Attach a prefix/suffix to a callsign (type-2 messages)."""
    if nprefix < 60000:
        n = nprefix
        pfx = ""
        for _ in range(3):
            nc = n % 37
            if 0 <= nc <= 9:
                pfx = chr(nc + 48) + pfx
            elif 10 <= nc <= 35:
                pfx = chr(nc + 55) + pfx
            else:
                pfx = " " + pfx
            n //= 37
        # keep everything after the last space
        pfx = pfx.rsplit(" ", 1)[-1]
        return f"{pfx}/{call}"
    nc = nprefix - 60000
    if 0 <= nc <= 9:
        return f"{call}/{chr(nc + 48)}"
    if 10 <= nc <= 35:
        return f"{call}/{chr(nc + 55)}"
    if 36 <= nc <= 125:
        return f"{call}/{chr((nc - 26) // 10 + 48)}{chr((nc - 26) % 10 + 48)}"
    return None


# ---------------------------------------------------------------------------
# Full message unpack (types 1/2/3) and pack (type 1)
# ---------------------------------------------------------------------------

_ALLOWED_POWER_UNITS = (0, 3, 7)


@dataclass
class HashTable:
    """32768-slot callsign table for type-3 messages (hashtable.txt format)."""

    slots: dict[int, str] = field(default_factory=dict)

    def insert(self, callsign: str) -> None:
        self.slots[nhash(callsign)] = callsign

    def lookup(self, ihash: int) -> str | None:
        return self.slots.get(ihash)

    @classmethod
    def load(cls, path: str | os.PathLike = "hashtable.txt") -> "HashTable":
        table = cls()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        table.slots[int(parts[0])] = parts[1]
        return table

    def save(self, path: str | os.PathLike = "hashtable.txt") -> None:
        with open(path, "w") as f:
            for i in sorted(self.slots):
                f.write(f"{i:5d} {self.slots[i]}\n")


@dataclass
class Unpacked:
    """Result of unpacking a 50-bit WSPR payload."""

    text: str            # "CALL GRID dBm" / "CALL dBm" / "<CALL> GRID6 dBm"
    callsign: str
    grid: str | None
    power_dbm: int | None
    msg_type: int        # 1, 2, or 3
    noprint: bool        # reference would suppress printing this spot


def unpack_message(data: bytes | np.ndarray,
                   hashtable: HashTable | None = None) -> Unpacked | None:
    """7-byte payload -> decoded message (reference: helpers.cc:494-590)."""
    n1, n2 = unpack50(data)
    callsign = unpack_callsign(n1)
    if callsign is None:
        return None
    grid = unpack_grid(n2)
    if grid is None:
        return None
    ntype = (n2 & 127) - 64
    noprint = False

    if 0 <= ntype <= 62:
        nu = ntype % 10
        if nu in _ALLOWED_POWER_UNITS:
            # Type 1: callsign + grid + power
            ndbm = ntype
            text = f"{callsign} {grid} {ndbm:2d}"
            if hashtable is not None:
                hashtable.insert(callsign)
            return Unpacked(text, callsign, grid, ndbm, 1, noprint)
        # Type 2: extended callsign + power
        nadd = nu
        if nu > 3:
            nadd = nu - 3
        if nu > 7:
            nadd = nu - 7
        n3 = n2 // 128 + 32768 * (nadd - 1)
        extcall = unpack_prefix(n3, callsign)
        if extcall is None:
            return None
        ndbm = ntype - nadd
        text = f"{extcall} {ndbm:2d}"
        if ndbm % 10 in (0, 3, 7) or ndbm % 10 == 10:
            if hashtable is not None:
                hashtable.insert(extcall)
        else:
            noprint = True
        return Unpacked(text, extcall, None, ndbm, 2, noprint)

    if ntype < 0:
        # Type 3: hashed callsign + 6-char grid + power.  The "callsign"
        # field actually carries the locator rotated right by one character
        # (helpers.cc:552-558; hardcoded length 6).
        ndbm = -(ntype + 1)
        cs = callsign
        grid6 = (cs[5] if len(cs) > 5 else "") + cs[:5]
        nu = ndbm % 10
        if (nu not in (0, 3, 7) and nu != 10) or \
           len(grid6) < 4 or not (grid6[0].isalpha() and grid6[1].isalpha()
                                  and grid6[2].isdigit() and grid6[3].isdigit()):
            noprint = True
        ihash = (n2 - ntype - 64) // 128
        stored = hashtable.lookup(ihash) if hashtable is not None else None
        shown = f"<{stored}>" if stored else "<...>"
        text = f"{shown} {grid6} {ndbm:2d}"
        if ntype == -64:
            noprint = True
        return Unpacked(text, shown, grid6, ndbm, 3, noprint)

    return None


def _check_power(power_dbm: int) -> None:
    if power_dbm % 10 not in _ALLOWED_POWER_UNITS or not 0 <= power_dbm <= 62:
        raise ValueError(f"power {power_dbm} dBm not in the WSPR set "
                         f"(0..60, last digit 0/3/7)")


def pack_prefix(pfx: str) -> int:
    """1-3 char prefix -> nprefix < 60000 (inverse of unpack_prefix's
    base-37 loop, reference helpers.cc:436-462: chars packed MSB-first,
    left-padded with spaces to 3)."""
    pfx = pfx.upper()
    if not 1 <= len(pfx) <= 3:
        raise ValueError(f"prefix {pfx!r} must be 1-3 characters")
    n = 0
    for ch in f"{pfx:>3s}":
        if ch.isdigit():
            v = ord(ch) - 48
        elif "A" <= ch <= "Z":
            v = ord(ch) - 55
        elif ch == " ":
            v = 36
        else:
            raise ValueError(f"invalid prefix character {ch!r}")
        n = n * 37 + v
    return n


def pack_suffix(sfx: str) -> int:
    """1-2 char suffix -> nprefix >= 60000 (inverse of unpack_prefix's
    suffix branch: single digit/letter, or two digits 10-99)."""
    sfx = sfx.upper()
    if len(sfx) == 1:
        if sfx.isdigit():
            return 60000 + ord(sfx) - 48
        if "A" <= sfx <= "Z":
            return 60000 + ord(sfx) - 55
    elif len(sfx) == 2 and sfx.isdigit() and sfx[0] != "0":
        return 60000 + 26 + int(sfx)
    raise ValueError(f"suffix {sfx!r} must be one digit/letter or "
                     f"two digits 10-99")


def pack_message_type2(compound_callsign: str, power_dbm: int) -> np.ndarray:
    """Type-2 "PFX/CALL dBm" or "CALL/SFX dBm" -> 11-byte payload.

    Inverse of the type-2 branch of unpack_message (reference
    helpers.cc:520-538): the 28-bit field carries the base callsign, the
    22-bit field carries nprefix split as
    n2 = (nprefix % 32768) * 128 + (power + nadd) + 64 with
    nadd = nprefix // 32768 + 1 encoded into the power's unit digit.
    """
    _check_power(power_dbm)
    parts = compound_callsign.upper().split("/")
    if len(parts) != 2 or not parts[0] or not parts[1]:
        raise ValueError(f"{compound_callsign!r} is not PFX/CALL or "
                         f"CALL/SFX")
    left, right = parts
    if len(right) <= 2:                     # CALL/SFX
        base, n3 = left, pack_suffix(right)
    elif len(left) <= 3:                    # PFX/CALL
        base, n3 = right, pack_prefix(left)
    else:
        raise ValueError(f"{compound_callsign!r}: prefix is 1-3 chars, "
                         f"suffix 1-2")
    n1 = pack_callsign(base)
    nadd = n3 // 32768 + 1                  # 1 or 2 for all valid nprefix
    ntype = power_dbm + nadd
    n2 = (n3 % 32768) * 128 + ntype + 64
    return pack50(n1, n2)


def pack_message_type3(callsign: str, grid6: str,
                       power_dbm: int) -> np.ndarray:
    """Type-3 "<CALL> GRID6 dBm" -> 11-byte payload.

    Inverse of the type-3 branch of unpack_message (reference
    helpers.cc:540-590): the 28-bit callsign field carries the 6-char
    locator rotated LEFT by one character, the 22-bit field carries the
    15-bit callsign hash and the power as ntype = -(power+1). Receivers
    print the callsign only if an earlier type-1/2 decode populated their
    hashtable with it.
    """
    _check_power(power_dbm)
    grid6 = grid6.upper()
    if (len(grid6) != 6 or not (grid6[0].isalpha() and grid6[1].isalpha()
                                and grid6[2].isdigit()
                                and grid6[3].isdigit()
                                and grid6[4].isalpha()
                                and grid6[5].isalpha())):
        raise ValueError(f"invalid 6-char locator {grid6!r}")
    # unpack derotates as grid6 = cs[5] + cs[:5], so pack rotates left
    n1 = pack_callsign(grid6[1:] + grid6[0])
    ihash = nhash(callsign.strip().upper())
    ntype = -(power_dbm + 1)
    n2 = 128 * ihash + ntype + 64
    return pack50(n1, n2)


def pack_message(callsign: str, grid: str | None,
                 power_dbm: int) -> np.ndarray:
    """Message -> 11-byte payload (50 info bits + zeros), all types.

    Dispatch mirrors the reference's message forms (helpers.cc:436-590):
    a "/" in the callsign selects type 2 (compound call + power, no
    grid), a 6-char locator selects type 3 (hashed call + subsquare
    grid), otherwise type 1 "CALL GRID dBm".
    """
    if "/" in callsign:
        if grid:
            raise ValueError("type-2 (compound callsign) messages carry "
                             "no grid; pass grid=None")
        return pack_message_type2(callsign, power_dbm)
    if grid is not None and len(grid) == 6:
        return pack_message_type3(callsign, grid, power_dbm)
    _check_power(power_dbm)
    n1 = pack_callsign(callsign)
    n2 = pack_grid(grid) * 128 + power_dbm + 64
    return pack50(n1, n2)


__all__ = [
    "nhash", "unpack50", "pack50", "unpack_callsign", "pack_callsign",
    "unpack_grid", "pack_grid", "unpack_prefix", "pack_prefix",
    "pack_suffix", "HashTable", "Unpacked", "unpack_message",
    "pack_message", "pack_message_type2", "pack_message_type3",
]
