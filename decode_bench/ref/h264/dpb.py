"""H.264 DPB, reference-frame marking, and reference-list construction.

Exact behavioral mirror of the reference's POC-ordered DPB
(reference: src/lib/h264.cpp:695-815 dpb ops, :10665-11003 marking +
ref-list ordering, :924-962 find_empty_frame LRU).
"""

from __future__ import annotations

import dataclasses

NOT_IN_USE, SHORT_TERM, LONG_TERM = 0, 1, 2


@dataclasses.dataclass
class DpbElem:
    poc: int
    frame_idx: int
    is_idr: int = 0
    is_terminal: int = 0


class Dpb:
    """POC-sorted output queue (h264.cpp:695-815)."""

    def __init__(self, maxsize=-1):
        self.data: list[DpbElem] = []
        self.max = maxsize
        self.output = -1
        self.is_ready = 0

    def set_max(self, sps):
        """set_dpb_max (h264.cpp:1219-1226) with its arithmetic quirks:
        int16 max_dpb_in_mbs / uint32 mb-count promotes BOTH to uint32
        (levels >= 4.0, wrapped negative, become ~4 billion => dpb 16 for
        any frame >= 2 MBs), and the result is stored into an int8 field.
        Single-MB frames at such levels yield max=0, where the reference
        corrupts its own heap (data[-1] writes in dpb_insert_idr) --
        excluded as UB."""
        if self.max < 0:
            x = (sps.pic_width * sps.pic_height) >> 8
            num = (sps.max_dpb_in_mbs & 0xFFFFFFFF) // x  # int/uint32 div
            if num >= 1 << 31:
                num -= 1 << 32
            v = 16 if num > 16 else num
            v &= 0xFF  # int8 store
            self.max = v - 256 if v >= 128 else v
            if self.max <= 0:
                raise NotImplementedError(
                    "dpb max <= 0 (reference heap-corruption domain: "
                    "single-MB frame at level >= 4.0)")

    def insert_non_idr(self, poc, frame_idx):
        """Exact mirror of dpb_insert_non_idr (h264.cpp:713-745)."""
        a = self.data
        size = len(a)
        if size > 0:
            di = size
            while True:  # do { --d; } while (d != begin && !terminal && poc < d->poc)
                di -= 1
                if di == 0 or a[di].is_terminal or not poc < a[di].poc:
                    break
            if size < self.max:
                self.output = -1
                if a[di].is_terminal or a[di].poc < poc:
                    di += 1
                a.insert(di, DpbElem(poc, frame_idx))
            else:
                self.output = a[0].frame_idx
                if a[0].is_terminal:
                    self.is_ready = 0
                # memmove(data, data+1, d-data); write new at d
                self.data = a[1:di + 1] + [DpbElem(poc, frame_idx)] + a[di + 1:]
        else:
            self.output = -1
            a.append(DpbElem(poc, frame_idx))

    def insert_idr(self, poc, frame_idx):
        if len(self.data) >= self.max:
            self.output = self.data[0].frame_idx
            if self.data[0].is_terminal:
                self.is_ready = 0
            self.data.pop(0)
        if self.data:
            self.data[-1].is_terminal = 1
            self.is_ready = 1
        self.data.append(DpbElem(0, frame_idx, is_idr=1))

    def insert(self, poc, frame_idx, is_idr):
        if is_idr:
            self.insert_idr(poc, frame_idx)
        else:
            self.insert_non_idr(poc, frame_idx)

    def force_pop(self):
        if self.output >= 0:
            idx = self.output
            self.output = -1
            return idx
        if not self.data:
            return -1
        self.output = -1
        if self.data[0].is_terminal:
            self.is_ready = 0
        return self.data.pop(0).frame_idx

    def force_peek(self):
        if self.output >= 0:
            return self.output
        if not self.data:
            return -1
        return self.data[0].frame_idx

    def exists(self, frame_idx):
        return any(d.frame_idx == frame_idx for d in self.data)


@dataclasses.dataclass
class RefFrame:
    """h264d_ref_frame_t (h264.h:205-211)."""

    in_use: int = NOT_IN_USE
    frame_idx: int = -1
    num: int = 0
    poc: int = 0
    col: object = None  # colocated motion page (list-1 only)

    def key(self):
        return (self.in_use, self.frame_idx, self.num, self.poc)


def marking_sliding_window(refs, frame_ptr, frame_num, max_frame_num,
                           num_ref_frames, poc):
    """h264.cpp:10665-10703."""
    min_num, min_idx, empty_idx = None, 0, -1
    num_used = 0
    for i in range(16):
        use = refs[i].in_use
        if use == NOT_IN_USE:
            if empty_idx < 0:
                empty_idx = i
        else:
            num_used += 1
            if use == SHORT_TERM:
                num = refs[i].num
                if frame_num < num:
                    num -= max_frame_num
                if min_num is None or num < min_num:
                    min_num, min_idx = num, i
    if num_used < num_ref_frames:
        tgt = empty_idx if empty_idx >= 0 else num_ref_frames - 1
    else:
        tgt = min_idx
    r = refs[tgt]
    r.in_use = SHORT_TERM
    r.frame_idx = frame_ptr
    r.num = frame_num
    r.poc = poc
    return r


def _mmco_discard(refs, in_use, target_num):
    for r in refs:
        if r.num == target_num and r.in_use == in_use:
            r.in_use = NOT_IN_USE
            break


def marking_mmco(mmcos, refs, frame_ptr, frame_num, max_frame_num,
                 num_ref_frames, poc):
    """h264.cpp:10785-10812."""
    op5 = op6 = False
    for op, arg1, arg2 in mmcos:
        if op == 0:
            break
        if op == 1:
            num = frame_num - arg1 - 1
            while num < 0:
                num += max_frame_num
            _mmco_discard(refs, SHORT_TERM, num)
        elif op == 2:
            _mmco_discard(refs, LONG_TERM, arg1)
        elif op == 3:
            tnum = frame_num - arg1 - 1
            while tnum < 0:
                tnum += max_frame_num
            for r in refs:
                if r.in_use == LONG_TERM and r.num == arg2:
                    r.in_use = NOT_IN_USE
                elif r.in_use == SHORT_TERM and r.num == tnum:
                    r.in_use = LONG_TERM
                    r.num = arg2
        elif op == 4:
            for r in refs:
                if r.in_use == LONG_TERM and arg1 <= r.num:
                    r.in_use = NOT_IN_USE
        elif op == 5:
            op5 = True
            for r in refs:
                r.in_use = NOT_IN_USE
        elif op == 6:
            op6 = True
            r = marking_sliding_window(refs, frame_ptr, frame_num,
                                       max_frame_num, num_ref_frames, poc)
            r.in_use = LONG_TERM
            r.num = arg1
    if not op6:
        if op5:
            frame_num = poc = 0
        marking_sliding_window(refs, frame_ptr, frame_num, max_frame_num,
                               num_ref_frames, poc)
    return op5


def _merge_sort(items, less):
    """Stable merge sort mirroring std::sort-compatible strict-weak order.

    std::sort is not stable, but the reference relies on its libstdc++
    behavior only through orderings that are total on distinct elements;
    stable sort yields identical results for those.
    """
    import functools

    return sorted(items, key=functools.cmp_to_key(
        lambda a, b: -1 if less(a, b) else (1 if less(b, a) else 0)))


def _ref_list_order(lhs, rhs, get_num, less_short):
    """h264.cpp:10916-10940."""
    if lhs.in_use == SHORT_TERM:
        return True if rhs.in_use != SHORT_TERM else less_short(get_num(lhs), get_num(rhs))
    if lhs.in_use == LONG_TERM:
        if rhs.in_use == SHORT_TERM:
            return False
        if rhs.in_use == LONG_TERM:
            return get_num(lhs) < get_num(rhs)
        return True
    return False


def ref_pic_init_p(refs, frame_num, max_frame_num, num_ref_frames):
    """h264.cpp:10970-10974."""
    def unwrap(s):
        return s - max_frame_num if frame_num < s else s

    def less(a, b):
        return _ref_list_order(a, b, lambda r: r.num,
                               lambda l, r: unwrap(l) > unwrap(r))

    refs[:num_ref_frames] = _merge_sort(refs[:num_ref_frames], less)


def ref_pic_init_b(refs0, refs1, poc, num_ref_frames):
    """h264.cpp:10981-10995."""
    def less_l0(l, r):
        if l < poc:
            return (poc < r) or (l > r)
        return (poc < r) and (l < r)

    def less_l1(l, r):
        if l > poc:
            return (poc > r) or (l < r)
        return (poc > r) and (l > r)

    def mk(less_poc):
        def less(a, b):
            return _ref_list_order(a, b, lambda rr: rr.poc, less_poc)
        return less

    refs0[:num_ref_frames] = _merge_sort(refs0[:num_ref_frames], mk(less_l0))
    refs1[:num_ref_frames] = _merge_sort(refs1[:num_ref_frames], mk(less_l1))
    # NOTE: the spec's "swap ref1[0]/ref1[1] if lists identical" is DEAD
    # CODE in the reference: is_same_list (h264.cpp:10977-10980) memcmps
    # whole structs including the col pointer, which is non-NULL only in
    # list 1 (init_mb_buffer, h264.cpp:539-544), so it never reports
    # equality.  We mirror the reference: no swap.
    for i in range(num_ref_frames, 16):
        refs0[i].in_use = NOT_IN_USE
        refs1[i].in_use = NOT_IN_USE


def calc_short_term(idc, num, frame_num, max_frame_num):
    """h264.cpp:1583-1599."""
    if idc == 0:
        no_wrap = frame_num - num - 1
        while no_wrap < 0:
            no_wrap += max_frame_num
    else:
        no_wrap = frame_num + num + 1
        while no_wrap >= max_frame_num:
            no_wrap -= max_frame_num
    return no_wrap


def ref_pic_list_reordering(r, refs, num_ref_frames, frame_num, max_frame_num):
    """h264.cpp:1623-1666. Mutates the 16-entry refs list in place."""
    if not r.get_onebit():
        return
    REF_MAX = 16
    ref_idx = -1
    while True:
        ref_idx += 1
        if ref_idx >= REF_MAX:
            break
        idc = r.ue()
        if idc == 3:
            break
        if idc > 3:
            raise ValueError("bad reordering idc")
        num = r.ue()
        if idc < 2:
            num = calc_short_term(idc, num, frame_num, max_frame_num)
            frame_num = num
            mode = SHORT_TERM
        else:
            mode = LONG_TERM

        def is_target(e):
            return e.num == num and e.in_use == mode

        if is_target(refs[ref_idx]):
            # remove duplicates after current position (std::remove_if
            # without erase: survivors shift forward, tail keeps stale
            # copies — replicate exactly)
            _remove_if_noerase(refs, ref_idx + 1, REF_MAX, is_target)
        else:
            target = next((i for i in range(REF_MAX) if is_target(refs[i])), -1)
            if target >= 0:
                tmp = dataclasses.replace(refs[target])
                tmp.col = refs[target].col
                _remove_if_noerase(refs, ref_idx + 1, REF_MAX, is_target)
                # memmove: shift [ref_idx .. 14] down one slot
                for i in range(REF_MAX - 1, ref_idx, -1):
                    refs[i] = refs[i - 1]
                refs[ref_idx] = tmp


def _remove_if_noerase(refs, begin, end, pred):
    """std::remove_if semantics on the slice [begin, end): survivors are
    compacted to the front; the tail retains whatever was there (moved-from
    values in C++ = original values for PODs)."""
    # copy survivors (C++ value semantics — Python objects must not alias)
    survivors = [
        dataclasses.replace(refs[i])
        for i in range(begin, end)
        if not pred(refs[i])
    ]
    for k, s in enumerate(survivors):
        refs[begin + k] = s
    # tail entries keep their previous contents (std::remove_if leaves them)
