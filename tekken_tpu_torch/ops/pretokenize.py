r"""Piece-boundary rules of the Tekken pre-tokenizer as torch tensor ops.

The hardcoded pattern

    (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|
     ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+

tiles its input, so tokenization is fixed by where matches start.  The
start flags are closed-form rules over character classes (derivation in
the JAX package's ops/pretokenize.py, which these functions mirror bit for
bit).  Every function works row-wise over the last axis of a (B, R)
buffer; rows are independent documents.

- ``ascii_classes_arith``, ``_char_boundaries_simple`` and
  ``_char_boundaries_general`` are the plain versions of the rule sets
  that the stage-1 kernel evaluates in-kernel (csrc/stage1_compact.cu).
- ``byte_char_structure`` and ``byte_boundaries`` compute the route-3
  (UTF-8) flags that the kernel takes as its ``external`` input.
- The differential formulations, held against the above in the tests:
  ``_char_boundaries`` (the full rule set on native cumulative scans),
  ``byte_boundaries_ascii`` / ``byte_boundaries_ascii_simple`` (ASCII rows
  through it and through the simple rules, with ``ascii_packed_lookup``'s
  classes), ``byte_boundaries_via_chars`` (chars compacted by scatter,
  ``_char_boundaries``, flags scattered back) and ``pretokenize_vec``
  (one string through ``byte_boundaries``, split on the host).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "data", "unicode_tables.npz")

# class bits in the unicode table
_LETTER, _NUMBER, _WS = 1, 2, 4
# contraction fold ids: 1..8 = s,t,r,e,v,m,l,d
_F_S, _F_T, _F_R, _F_E, _F_V, _F_M, _F_L, _F_D = range(1, 9)

BIG = 1 << 30
# the longest row the general ASCII rules take (the JAX package's bound)
GENERAL_MAX_ROW = 8192


@functools.lru_cache(maxsize=1)
def unicode_tables() -> tuple[np.ndarray, np.ndarray]:
    z = np.load(_DATA)
    return z["cls"], z["fold"]


@functools.lru_cache(maxsize=1)
def unicode_packed_table() -> np.ndarray:
    """cls (bits 0-2) | fold << 3 (bits 3-6) per codepoint, uint8."""
    cls, fold = unicode_tables()
    return (cls | (fold << 3)).astype(np.uint8)


@functools.lru_cache(maxsize=4)
def _packed_table_on(device: str) -> torch.Tensor:
    return torch.from_numpy(unicode_packed_table().astype(np.int32)).to(device)


def _sh(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """Value at index i+k along the last axis (row-local), ``fill`` past
    the row edge."""
    if k == 0:
        return x
    n = x.shape[-1]
    m = min(abs(k), n)
    pad = torch.full(x.shape[:-1] + (m,), fill, dtype=x.dtype,
                     device=x.device)
    if m == n:
        return pad
    if k > 0:
        return torch.cat([x[..., k:], pad], dim=-1)
    return torch.cat([pad, x[..., :k]], dim=-1)


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=-1).values


def _rcummin(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, [-1]), dim=-1).values, [-1])


def _iota(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[-1], dtype=torch.int64, device=x.device)


def ascii_classes_arith(byts: torch.Tensor) -> torch.Tensor:
    """pk-layout class+fold value for ASCII bytes via compares (ASCII \\s is
    exactly {9..13, 32}, letters A-Za-z, digits 0-9; the contraction folds
    are the 8 lowercased letters).  Returns int64."""
    b = byts.to(torch.int64)
    lo = b | 32
    is_l = (lo >= 97) & (lo <= 122)
    is_n = (b >= 48) & (b <= 57)
    is_w = (b == 32) | ((b >= 9) & (b <= 13))
    fold = torch.zeros_like(b)
    for fid, ch in zip(range(1, 9), b"strevmld"):
        fold = torch.where(is_l & (lo == ch), fid, fold)
    return (is_l.to(torch.int64) | (is_n.to(torch.int64) << 1)
            | (is_w.to(torch.int64) << 2) | (fold << 3))


def _classes(cp, is_valid, pk):
    cp = torch.where(is_valid, cp.to(torch.int64), 0)
    pk = torch.where(is_valid, pk.to(torch.int64), 0)
    cls = pk & 7
    fold = (pk >> 3) & 0x1F
    is_l = (cls & _LETTER) != 0
    is_n = (cls & _NUMBER) != 0
    is_w = (cls & _WS) != 0
    is_p = is_valid & ~is_l & ~is_n & ~is_w
    is_nl = is_valid & ((cp == 0x0D) | (cp == 0x0A))
    is_space = is_valid & (cp == 0x20)
    is_apos = is_valid & (cp == 0x27)
    g = torch.where(is_l, 0, torch.where(is_n, 1, torch.where(
        is_w, 2, torch.where(is_p, 3, 4))))
    one = torch.ones(g.shape[:-1] + (1,), dtype=torch.bool, device=g.device)
    change = torch.cat([one, g[..., 1:] != g[..., :-1]], dim=-1)
    change_next = torch.cat([g[..., :-1] != g[..., 1:], one], dim=-1)
    return (fold, is_l, is_n, is_w, is_p, is_nl, is_space, is_apos,
            change, change_next)


def _contraction(fold, is_l, is_p, is_apos, change, change_next,
                 p_is_space):
    """Contraction at a free length-1 apostrophe run: bit 0 consumes one
    letter ('s 't 'm 'd), bit 1 two ('re 've 'll)."""
    f1 = _sh(fold, 1, 0)
    f2 = _sh(fold, 2, 0)
    next_is_letter = _sh(is_l, 1, False)
    has_l2 = _sh(is_l, 2, False) & ~_sh(change, 2, True)
    p_free_apos = is_p & is_apos & change & change_next & ~p_is_space
    one_letter = (f1 == _F_S) | (f1 == _F_T) | (f1 == _F_M) | (f1 == _F_D)
    two_letter = ((((f1 == _F_R) | (f1 == _F_V)) & has_l2 & (f2 == _F_E))
                  | ((f1 == _F_L) & has_l2 & (f2 == _F_L)))
    contraction = p_free_apos & next_is_letter & (one_letter | two_letter)
    return ((contraction & one_letter).to(torch.int64)
            | ((contraction & two_letter).to(torch.int64) << 1))


def _char_boundaries(cp, is_valid, pk=None):
    """Piece-start flags at char positions, row-local over the last axis:
    the full rule set with native cumulative scans (torch cummax /
    cummin) for the run-level rules.  The independent reference that the
    log-doubling and byte-level formulations are held against; it shares
    no rule code with them.  ``pk`` (class | fold << 3 per char) defaults
    to a gather of the Unicode table at ``cp``.  Mirrors the JAX
    package's ``_char_boundaries`` (derivation of rule E there)."""
    idx = _iota(cp)
    cp = torch.where(is_valid, cp.to(torch.int64), 0)
    if pk is None:
        tab = _packed_table_on(str(cp.device))
        pk = tab[cp.clamp(0, tab.shape[0] - 1)]
    pk = torch.where(is_valid, pk.to(torch.int64), 0)
    cls = pk & 7
    fold = (pk >> 3) & 0x1F

    is_l = (cls & _LETTER) != 0
    is_n = (cls & _NUMBER) != 0
    is_w = (cls & _WS) != 0
    is_p = is_valid & ~is_l & ~is_n & ~is_w
    is_nl = is_valid & ((cp == 0x0D) | (cp == 0x0A))
    is_space = is_valid & (cp == 0x20)
    is_apos = is_valid & (cp == 0x27)

    g = torch.where(is_l, 0, torch.where(is_n, 1, torch.where(
        is_w, 2, torch.where(is_p, 3, 4))))
    one = torch.ones(g.shape[:-1] + (1,), dtype=torch.bool, device=g.device)
    change = torch.cat([one, g[..., 1:] != g[..., :-1]], dim=-1)
    change_next = torch.cat([g[..., :-1] != g[..., 1:], one], dim=-1)

    # native cumulative scans
    S = _cummax(torch.where(change, idx, -1))                 # run start
    u = _cummax(torch.where(~is_nl & is_valid, idx, -1))      # last non-nl
    f = _rcummin(torch.where(is_nl, idx, BIG))                # first nl >= i

    # shifted neighbour context
    p_is_w = _sh(is_w, -1, False)
    p_is_nl = _sh(is_nl, -1, False)
    p_is_p = _sh(is_p, -1, False)
    p_is_space = _sh(is_space, -1, False)
    p_change = _sh(change, -1, False)
    p2_is_space = _sh(is_space, -2, False)
    u_prev = _sh(u, -1, -1)
    f_prev = _sh(f, -1, BIG)
    next_valid = _sh(is_valid, 1, False)

    # contraction at a free length-1 apostrophe run
    f1 = _sh(fold, 1, 0)
    f2 = _sh(fold, 2, 0)
    next_is_letter = _sh(is_l, 1, False)
    has_l2 = _sh(is_l, 2, False) & ~_sh(change, 2, True)
    p_free_apos = is_p & is_apos & change & change_next & ~p_is_space
    one_letter = (f1 == _F_S) | (f1 == _F_T) | (f1 == _F_M) | (f1 == _F_D)
    two_letter = ((((f1 == _F_R) | (f1 == _F_V)) & has_l2 & (f2 == _F_E))
                  | ((f1 == _F_L) & has_l2 & (f2 == _F_L)))
    contraction = p_free_apos & next_is_letter & (one_letter | two_letter)
    cons1 = contraction & one_letter
    cons2 = contraction & two_letter

    # rule A: number runs split into triples
    b_num = is_n & (((idx - S) % 3) == 0)
    # rule B: letter-run start
    absorbed = (p_is_w & ~p_is_nl) | (p_is_p & p_change & ~p2_is_space)
    b_letter_start = is_l & change & ~((idx > 0) & absorbed)
    # rule C: post-contraction remainder
    b_letter_cont = is_l & ~change & (
        (_sh(change, -1, False) & _sh(cons1, -2, False))
        | (_sh(change, -2, False) & ~_sh(change, -1, False)
           & _sh(cons2, -3, False)))
    # rule D: punct-run start
    b_punct = is_p & change & ~((idx > 0) & p_is_space)

    # rule E: whitespace runs; "the char before this run is P" broadcast
    # from the run start by one cummax (idx increases, so the latest run
    # start wins)
    packed = torch.where(change, idx * 2 + p_is_p.to(torch.int64), -1)
    prev_run_is_p = (_cummax(packed) & 1) == 1
    run_continues = ~change
    nxt_change_pos = _rcummin(torch.where(change_next, idx, BIG))  # run end
    no_nl_to_end = f > nxt_change_pos
    no_nl_to_end_prev = f_prev > nxt_change_pos
    is_entry = is_w & torch.where(prev_run_is_p, ~is_nl & (u_prev < S),
                                  change)
    prev_ge_entry = torch.where(prev_run_is_p, u_prev >= S, True)
    b_ws_tail = (is_w & run_continues & p_is_nl & prev_ge_entry
                 & no_nl_to_end & ~is_entry)
    b_ws_last = (is_w & change_next & next_valid & run_continues
                 & ~p_is_nl & no_nl_to_end_prev)
    b_ws = is_entry | b_ws_tail | b_ws_last

    return (b_num | b_letter_start | b_letter_cont | b_punct
            | b_ws) & is_valid


def _char_boundaries_simple(cp, is_valid, pk):
    """Scan-free boundary rules for SIMPLE rows: no whitespace run longer
    than 1 char and no digit run longer than 3 (the caller routes).  Under
    those constraints every run-level rule collapses to neighbour shifts.
    Mirrors the JAX package's ``_char_boundaries_simple``."""
    idx = _iota(cp)
    (fold, is_l, is_n, is_w, is_p, is_nl, is_space, is_apos, change,
     change_next) = _classes(cp, is_valid, pk)

    p_is_w = _sh(is_w, -1, False)
    p_is_nl = _sh(is_nl, -1, False)
    p_is_p = _sh(is_p, -1, False)
    p_is_space = _sh(is_space, -1, False)
    p_change = _sh(change, -1, False)
    p_change2 = _sh(change, -2, False)
    p2_is_space = _sh(is_space, -2, False)

    cons = _contraction(fold, is_l, is_p, is_apos, change, change_next,
                        p_is_space)
    cm2 = _sh(cons, -2, 0)
    cm3 = _sh(cons, -3, 0)

    b_num = is_n & change
    absorbed = (p_is_w & ~p_is_nl) | (p_is_p & p_change & ~p2_is_space)
    b_letter_start = is_l & change & ~((idx > 0) & absorbed)
    b_letter_cont = is_l & ~change & (
        (p_change & ((cm2 & 1) != 0))
        | (p_change2 & ~p_change & ((cm3 & 2) != 0)))
    b_punct = is_p & change & ~((idx > 0) & p_is_space)
    b_ws = is_w & ~(p_is_p & is_nl)
    return (b_num | b_letter_start | b_letter_cont | b_punct
            | b_ws) & is_valid


def _char_boundaries_general(cp, is_valid, pk):
    """The FULL boundary rule set, row-local over the last axis (any ASCII
    row: whitespace runs > 1 and digit runs > 3 allowed; chars == bytes).
    The run-level scans are torch cummax/cummin.  Mirrors the JAX
    package's ``_char_boundaries_general``, including its bound on the row
    length."""
    n = cp.shape[-1]
    if n > GENERAL_MAX_ROW:
        raise ValueError(f"general boundary rules take rows of <= "
                         f"{GENERAL_MAX_ROW} bytes, got {n}")
    idx = _iota(cp)
    (fold, is_l, is_n, is_w, is_p, is_nl, is_space, is_apos, change,
     change_next) = _classes(cp, is_valid, pk)

    S = _cummax(torch.where(change, idx, -1))                 # run start
    u = _cummax(torch.where(~is_nl & is_valid, idx, -1))      # last non-nl
    f = _rcummin(torch.where(is_nl, idx, BIG))                # first nl >= i
    nxt_change_pos = _rcummin(torch.where(change_next, idx, BIG))
    p_is_p = _sh(is_p, -1, False)
    prev_run_is_p = (_cummax(torch.where(
        change, idx * 2 + p_is_p.to(torch.int64), -1)) & 1) == 1

    p_is_w = _sh(is_w, -1, False)
    p_is_nl = _sh(is_nl, -1, False)
    p_is_space = _sh(is_space, -1, False)
    p_change = _sh(change, -1, False)
    p_change2 = _sh(change, -2, False)
    p2_is_space = _sh(is_space, -2, False)
    u_prev = _sh(u, -1, -1)
    f_prev = _sh(f, -1, BIG)
    next_valid = _sh(is_valid, 1, False)

    cons = _contraction(fold, is_l, is_p, is_apos, change, change_next,
                        p_is_space)
    cm2 = _sh(cons, -2, 0)
    cm3 = _sh(cons, -3, 0)

    # rule A: number runs split into triples from the run start
    d = torch.where(is_n, idx - S, 0)
    b_num = is_n & ((d % 3) == 0)
    # rule B: letter-run start
    absorbed = (p_is_w & ~p_is_nl) | (p_is_p & p_change & ~p2_is_space)
    b_letter_start = is_l & change & ~((idx > 0) & absorbed)
    # rule C: post-contraction remainder
    b_letter_cont = is_l & ~change & (
        (p_change & ((cm2 & 1) != 0))
        | (p_change2 & ~p_change & ((cm3 & 2) != 0)))
    # rule D: punct-run start
    b_punct = is_p & change & ~((idx > 0) & p_is_space)
    # rule E: whitespace runs (entry / tail / last sub-pieces)
    run_continues = ~change
    no_nl_to_end = f > nxt_change_pos
    no_nl_to_end_prev = f_prev > nxt_change_pos
    is_entry = is_w & ((prev_run_is_p & ~is_nl & (u_prev < S))
                       | (~prev_run_is_p & change))
    prev_ge_entry = ~prev_run_is_p | (u_prev >= S)
    b_ws_tail = (is_w & run_continues & p_is_nl & prev_ge_entry
                 & no_nl_to_end & ~is_entry)
    b_ws_last = (is_w & change_next & next_valid & run_continues
                 & ~p_is_nl & no_nl_to_end_prev)
    b_ws = is_entry | b_ws_tail | b_ws_last
    return (b_num | b_letter_start | b_letter_cont | b_punct
            | b_ws) & is_valid


def row_valid(byts: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, R) bool: lane < the row's length."""
    return _iota(byts)[None, :] < lengths.to(torch.int64).reshape(-1, 1)


def ascii_packed_lookup(byts: torch.Tensor) -> torch.Tensor:
    """cls | fold << 3 of ASCII bytes from the first 128 entries of the
    packed Unicode table (0 for bytes >= 0x80), uint8.  The JAX package
    computes it as a one-hot matmul for the TPU's matrix unit; here it is
    a direct index."""
    b = byts.to(torch.int64)
    tab = _packed_table_on(str(byts.device))
    return torch.where(b < 128, tab[b.clamp(0, 127)], 0).to(torch.uint8)


def byte_boundaries_ascii(byts: torch.Tensor, lengths: torch.Tensor,
                          pk: torch.Tensor) -> torch.Tensor:
    """Piece-start flags of all-ASCII rows (every byte a char) through the
    full rules of ``_char_boundaries``; ``pk`` from
    ``ascii_packed_lookup``."""
    return _char_boundaries(byts.to(torch.int64), row_valid(byts, lengths),
                            pk=pk)


def byte_boundaries_ascii_simple(byts: torch.Tensor, lengths: torch.Tensor,
                                 pk: torch.Tensor) -> torch.Tensor:
    """Piece-start flags of all-ASCII rows of a SIMPLE batch (no
    whitespace run > 1, no digit run > 3; the caller checks)."""
    return _char_boundaries_simple(byts.to(torch.int64),
                                   row_valid(byts, lengths), pk)


def ascii_boundaries(byts: torch.Tensor, lengths: torch.Tensor,
                     rules: str) -> torch.Tensor:
    """Piece-start flags of ASCII rows under ``rules`` "simple" or
    "general" (the plain version of the stage-1 kernel's in-kernel rules)."""
    valid = row_valid(byts, lengths)
    pk = ascii_classes_arith(byts)
    fn = _char_boundaries_simple if rules == "simple" \
        else _char_boundaries_general
    return fn(byts.to(torch.int64), valid, pk)


# --------------------------------------------------------------------- #
# byte-level UTF-8: structure + boundary flags (route 3)
# --------------------------------------------------------------------- #

def byte_char_structure(byts: torch.Tensor, lengths: torch.Tensor):
    """UTF-8 decode over padded rows.  Returns (is_lead bool (B, R),
    cp int64 (B, R) at lead positions, 0 elsewhere).  Assumes well-formed
    UTF-8 (text that came from a str)."""
    valid = row_valid(byts, lengths)
    b = torch.where(valid, byts.to(torch.int64), 0)
    is_cont = (b & 0xC0) == 0x80
    is_lead = valid & ~is_cont
    raw = byts.to(torch.int64)
    b1, b2, b3 = (_sh(raw, k, 0) & 0x3F for k in (1, 2, 3))
    cp2 = ((b & 0x1F) << 6) | b1
    cp3 = ((b & 0x0F) << 12) | (b1 << 6) | b2
    cp4 = ((b & 0x07) << 18) | (b1 << 12) | (b2 << 6) | b3
    cp = torch.where(b < 0x80, b, torch.where(
        b < 0xE0, cp2, torch.where(b < 0xF0, cp3, cp4)))
    return is_lead, torch.where(is_lead, cp, 0)


def byte_boundaries(byts: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Piece-start flags (B, R) bool over padded UTF-8 rows: True at the
    lead byte of each piece's first char.  The char-level rules run at
    byte granularity with every per-char value broadcast to the char's
    continuation bytes, so class runs are byte-contiguous and the scans
    work on byte positions.  Mirrors the JAX package's ``byte_boundaries``
    (an XLA op there, plain torch here)."""
    valid = row_valid(byts, lengths)
    idx = _iota(byts)
    is_lead, cp = byte_char_structure(byts, lengths)

    b = torch.where(valid, byts.to(torch.int64), 0)
    is_cont = valid & ((b & 0xC0) == 0x80)
    clen = torch.where(b < 0xC0, 1, torch.where(
        b < 0xE0, 2, torch.where(b < 0xF0, 3, 4)))
    cont1 = _sh(is_cont, -1, False)
    cont2 = _sh(is_cont, -2, False)
    ld = torch.where(is_cont, torch.where(
        cont1, torch.where(cont2, 3, 2), 1), 0)

    tab = _packed_table_on(str(byts.device))
    pk = tab[cp.clamp(0, tab.shape[0] - 1)].to(torch.int64)
    cls = pk & 7
    fold = (pk >> 3) & 0x1F
    W = (cls
         | torch.where((cp == 0x0D) | (cp == 0x0A), 8, 0)
         | torch.where(cp == 0x20, 16, 0)
         | torch.where(cp == 0x27, 32, 0)
         | 64
         | (fold << 8))
    W = torch.where(is_lead, W, 0)

    def bcast(arr, fill=0):
        # value at the owning lead, for every byte of the char
        return torch.where(ld == 0, arr, torch.where(
            ld == 1, _sh(arr, -1, fill), torch.where(
                ld == 2, _sh(arr, -2, fill), _sh(arr, -3, fill))))

    Wb = torch.where(valid, bcast(W), 0)
    is_l = (Wb & _LETTER) != 0
    is_n = (Wb & _NUMBER) != 0
    is_w = (Wb & _WS) != 0
    is_p = ((Wb & 64) != 0) & ((Wb & 7) == 0)
    is_nl = (Wb & 8) != 0
    is_apos = (Wb & 32) != 0
    fold_b = (Wb >> 8) & 0x1F

    g = torch.where(is_l, 0, torch.where(is_n, 1, torch.where(
        is_w, 2, torch.where(is_p, 3, 4))))
    one = torch.ones(g.shape[:-1] + (1,), dtype=torch.bool, device=g.device)
    change = torch.cat([one, g[..., 1:] != g[..., :-1]], dim=-1) & is_lead
    chg_next_b = torch.cat([g[..., :-1] != g[..., 1:], one], dim=-1)

    S = _cummax(torch.where(change, idx, -1))
    u = _cummax(torch.where(~is_nl & valid, idx, -1))
    f = _rcummin(torch.where(is_nl, idx, BIG))
    nxt_change_pos = _rcummin(torch.where(chg_next_b, idx, BIG))

    chb = bcast(change.to(torch.int64)) != 0   # per-char change, all bytes

    # previous char = any byte of it = byte i-1 (values are broadcast)
    Wm1 = _sh(Wb, -1, 0)
    p_is_w = (Wm1 & _WS) != 0
    p_is_nl = (Wm1 & 8) != 0
    p_is_p = ((Wm1 & 64) != 0) & ((Wm1 & 7) == 0)
    p_is_space = (Wm1 & 16) != 0
    p_change = _sh(chb, -1, False)

    # char -2 = byte (i - 2 - ld(i-1))
    ldm1 = _sh(ld, -1, 0)

    def at_prev2(arr, fill):
        return torch.where(ldm1 == 0, _sh(arr, -2, fill), torch.where(
            ldm1 == 1, _sh(arr, -3, fill), torch.where(
                ldm1 == 2, _sh(arr, -4, fill), _sh(arr, -5, fill))))

    p2_is_space = (at_prev2(Wb, 0) & 16) != 0

    # next char = byte i + clen(i)  (valid at leads)
    def at_next(arr, fill):
        return torch.where(clen == 1, _sh(arr, 1, fill), torch.where(
            clen == 2, _sh(arr, 2, fill), torch.where(
                clen == 3, _sh(arr, 3, fill), _sh(arr, 4, fill))))

    g_next = at_next(g, 4)
    change_next = g_next != g
    next_valid = at_next(valid, False)

    # contraction at a free length-1 apostrophe run (apos is 1 byte, but
    # the folded letters can be multi-byte, e.g. U+017F -> 's')
    f1 = at_next(fold_b, 0)
    n1_is_l = at_next(is_l, False)
    cl_next = at_next(clen, 1)     # byte length of char i+1

    def at_apos2(arr, fill):
        return torch.where(cl_next == 1, _sh(arr, 2, fill), torch.where(
            cl_next == 2, _sh(arr, 3, fill), torch.where(
                cl_next == 3, _sh(arr, 4, fill), _sh(arr, 5, fill))))

    f2 = at_apos2(fold_b, 0)
    has_l2 = at_apos2(is_l, False) & ~at_apos2(chb, True)
    p_free_apos = is_p & is_apos & change & change_next & ~p_is_space
    one_letter = (f1 == _F_S) | (f1 == _F_T) | (f1 == _F_M) | (f1 == _F_D)
    two_letter = ((((f1 == _F_R) | (f1 == _F_V)) & has_l2 & (f2 == _F_E))
                  | ((f1 == _F_L) & has_l2 & (f2 == _F_L)))
    contraction = p_free_apos & n1_is_l & (one_letter | two_letter)
    cons1 = contraction & one_letter
    cons2 = contraction & two_letter

    # rule A: number runs split into char-triples
    c_ord = torch.cumsum(is_lead.to(torch.int64), dim=-1) - 1
    cS = _cummax(torch.where(change, c_ord, -1))
    b_num = is_n & (((c_ord - cS) % 3) == 0)

    # rule B: letter-run start
    absorbed = (p_is_w & ~p_is_nl) | (p_is_p & p_change & ~p2_is_space)
    b_letter_start = is_l & change & ~((idx > 0) & absorbed)

    # rule C: post-contraction remainder, pushed forward from the apostrophe
    cb1 = torch.zeros_like(valid)
    for k in range(2, 6):                      # 1 + cl_next in 2..5
        cb1 = cb1 | _sh(cons1 & (cl_next == k - 1), -k, False)
    off2 = 1 + cl_next + at_apos2(clen, 1)
    cb2 = torch.zeros_like(valid)
    for k in range(3, 10):                     # off2 in 3..9
        cb2 = cb2 | _sh(cons2 & (off2 == k), -k, False)
    b_letter_cont = is_l & ~change & (cb1 | cb2)

    # rule D: punct-run start
    b_punct = is_p & change & ~((idx > 0) & p_is_space)

    # rule E: whitespace runs
    packed2 = torch.where(change, idx * 2 + p_is_p.to(torch.int64), -1)
    prev_run_is_p = (_cummax(packed2) & 1) == 1
    run_continues = ~change
    no_nl_to_end = f > nxt_change_pos
    no_nl_to_end_prev = _sh(f, -1, BIG) > nxt_change_pos
    u_prev = _sh(u, -1, -1)
    is_entry = is_w & torch.where(prev_run_is_p, ~is_nl & (u_prev < S),
                                  change)
    prev_ge_entry = torch.where(prev_run_is_p, u_prev >= S, True)
    b_ws_tail = (is_w & run_continues & p_is_nl & prev_ge_entry
                 & no_nl_to_end & ~is_entry)
    b_ws_last = (is_w & change_next & next_valid & run_continues
                 & ~p_is_nl & no_nl_to_end_prev)
    b_ws = is_entry | b_ws_tail | b_ws_last

    return ((b_num | b_letter_start | b_letter_cont | b_punct | b_ws)
            & valid & is_lead)


def byte_boundaries_via_chars(byts: torch.Tensor,
                              lengths: torch.Tensor) -> torch.Tensor:
    """Piece-start flags (B, R) bool of padded UTF-8 rows by char
    compaction: each row's chars are scattered into char order, run
    through ``_char_boundaries``, and the flags scattered back to their
    lead bytes.  The differential reference of ``byte_boundaries``."""
    is_lead, cp = byte_char_structure(byts, lengths)
    B, L = byts.shape
    idx = _iota(byts).expand(B, L)
    rows = torch.arange(B, device=byts.device)[:, None].expand(B, L)

    # char k of a row lives at byte lead_pos[k]; only lead bytes are
    # scattered (the JAX package drops the others out of range)
    char_idx = torch.cumsum(is_lead.to(torch.int64), dim=-1) - 1
    at = (rows[is_lead], char_idx[is_lead])
    lead_pos = torch.zeros((B, L), dtype=torch.int64, device=byts.device)
    lead_pos[at] = idx[is_lead]
    cp_char = torch.zeros((B, L), dtype=torch.int64, device=byts.device)
    cp_char[at] = cp[is_lead]
    nchars = is_lead.sum(dim=-1, keepdim=True)
    cb = _char_boundaries(cp_char, _iota(byts)[None, :] < nchars)

    out = torch.zeros((B, L), dtype=torch.bool, device=byts.device)
    out[rows[cb], lead_pos[cb]] = True
    return out & row_valid(byts, lengths)


def _bucket_len(n: int, minimum: int = 64) -> int:
    b = minimum
    while b < n:
        b <<= 1
    return b


def pretokenize_vec(text: str, device="cuda") -> list[str]:
    """Split ``text`` with the boundary rules on ``device``: one row,
    padded to a power-of-two bucket, through ``byte_boundaries``; the
    pieces are cut on the host.  Equals ``oracle.pretokenize``."""
    data = text.encode("utf-8")
    padded = np.zeros((1, _bucket_len(len(data))), dtype=np.uint8)
    padded[0, :len(data)] = np.frombuffer(data, dtype=np.uint8)
    byts = torch.from_numpy(padded).to(device)
    lens = torch.tensor([len(data)], dtype=torch.int32, device=byts.device)
    flags = byte_boundaries(byts, lens)[0, :len(data)].cpu().numpy()
    starts = np.flatnonzero(flags).tolist() + [len(data)]
    return [data[a:b].decode("utf-8") for a, b in zip(starts, starts[1:])]
