"""BigIntChip: multi-limb non-native integer arithmetic under PLONK
constraints (64-bit limbs, 32 limbs for 2048-bit integers).

Faithful capability port of reference/src/big_integer/ (chip.rs
~1378 non-test lines, mod.rs types, instructions.rs trait) onto the columnar
constraint system: Fresh/Muled range-typed integers, schoolbook mul
(circom-bigint style, chip.rs:389-422), mul_mod via witness (q, r) with
`a*b = q*n + r` (chip.rs:545-632), EqualWhenCarried muled equality
(chip.rs:825-898), the `a + max - b` overflow-flagged subtraction
(chip.rs:313-376), and the square-and-multiply pow_mod ladder
(chip.rs:667-745).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..cs import Builder, Cell, MainGate, RangeChip, Term

FRESH = "fresh"
MULED = "muled"

NUM_LOOKUP_LIMBS = 8  # chip.rs:1167


def decompose_big(value: int, num_limbs: int, limb_width: int) -> list[int]:
    """maingate::decompose_big analog (LSB-first limbs)."""
    mask = (1 << limb_width) - 1
    out = []
    for _ in range(num_limbs):
        out.append(value & mask)
        value >>= limb_width
    assert value == 0, "value does not fit"
    return out


@dataclass
class AssignedInteger:
    limbs: list[Cell]
    range_type: str  # FRESH | MULED

    def limb(self, i: int) -> Cell:
        return self.limbs[i]

    def num_limbs(self) -> int:
        return len(self.limbs)

    def to_big(self, width: int) -> int:
        v = 0
        for i in range(len(self.limbs) - 1, -1, -1):
            v = (v << width) | self.limbs[i].value
        return v

    def replace_limb(self, idx: int, cell: Cell) -> None:
        self.limbs[idx] = cell

    def clone(self) -> "AssignedInteger":
        return AssignedInteger(list(self.limbs), self.range_type)


class RefreshAux:
    """mod.rs:413-486: per-output-limb carry budget when normalizing a Muled
    integer back to limb_width-bit Fresh limbs."""

    def __init__(self, limb_width: int, num_limbs_l: int, num_limbs_r: int):
        self.limb_width = limb_width
        self.num_limbs_l = num_limbs_l
        self.num_limbs_r = num_limbs_r
        max_limb = (1 << limb_width) - 1
        d = num_limbs_l + num_limbs_r - 1
        muled = []
        for i in range(d):
            j = 0 if num_limbs_r >= i + 1 else i + 1 - num_limbs_r
            acc = 0
            while j < num_limbs_l and j <= i:
                acc += max_limb * max_limb
                j += 1
            muled.append(acc)
        increased = []
        cur_d = 0
        max_d = d
        while cur_d <= max_d:
            bits = muled[cur_d].bit_length()
            num_chunks = (bits + limb_width - 1) // limb_width if muled[cur_d] else 1
            if muled[cur_d] and bits % limb_width == 0:
                num_chunks = bits // limb_width
            increased.append(num_chunks - 1)
            chunks = []
            for _ in range(num_chunks):
                chunks.append(muled[cur_d] & max_limb)
                muled[cur_d] >>= limb_width
            assert muled[cur_d] == 0
            for j, ch in enumerate(chunks):
                if len(muled) <= cur_d + j:
                    muled.append(0)
                muled[cur_d + j] += ch
            cur_d += 1
        self.increased_limbs_vec = increased


class BigIntChip:
    def __init__(self, builder: Builder, limb_width: int, bits_len: int):
        assert bits_len % limb_width == 0
        self.b = builder
        self.mg = MainGate(builder)
        self.rc = RangeChip(builder)
        self.limb_width = limb_width
        self.num_limbs = bits_len // limb_width
        max_word = self.compute_mul_word_max(limb_width, self.num_limbs)
        assert max_word.bit_length() <= builder.field.num_bits

    # ---- static helpers (chip.rs:1355-1376) ---------------------------
    @staticmethod
    def bits_size(val: int) -> int:
        return val.bit_length()

    @staticmethod
    def sublimb_bit_len(bit_len_limb: int) -> int:
        val = bit_len_limb // NUM_LOOKUP_LIMBS
        return val if val else 1

    @staticmethod
    def compute_mul_word_max(limb_width: int, min_n: int) -> int:
        out_base = 1 << limb_width
        return min_n * (out_base - 1) ** 2 + (out_base - 1)

    @classmethod
    def compute_range_lens(cls, limb_width: int, num_limbs: int):
        """chip.rs:1224-1253 (informational: the columnar range chip derives
        its table from the tag widths actually used)."""
        out_comp = limb_width // NUM_LOOKUP_LIMBS
        out_overflow = limb_width % out_comp
        fresh_word_max_width = (2 * (1 << limb_width)).bit_length()
        fresh_carry_bits = fresh_word_max_width - limb_width
        fresh_comp = cls.sublimb_bit_len(fresh_carry_bits)
        mul_word_max = cls.compute_mul_word_max(limb_width, num_limbs)
        mul_word_max_width = (2 * mul_word_max).bit_length()
        mul_carry_bits = mul_word_max_width - limb_width
        mul_comp = cls.sublimb_bit_len(mul_carry_bits)
        return (
            [out_comp, fresh_comp, mul_comp],
            [out_overflow, fresh_carry_bits % fresh_comp, mul_carry_bits % mul_comp],
        )

    # ---- assignment ---------------------------------------------------
    def assign_integer(self, limb_values: list[int]) -> AssignedInteger:
        """Range-checked witness limbs (chip.rs:65-85)."""
        w = self.limb_width
        cells = [
            self.rc.assign(v, self.sublimb_bit_len(w), w) for v in limb_values
        ]
        return AssignedInteger(cells, FRESH)

    def assign_integer_from_big(self, value: int, num_limbs: int | None = None) -> AssignedInteger:
        n = num_limbs or self.num_limbs
        return self.assign_integer(decompose_big(value, n, self.limb_width))

    def _assign_constant(self, value: int, max_num_limbs: int, range_type: str) -> AssignedInteger:
        w = self.limb_width
        bits = self.bits_size(value)
        num = max(1, (bits + w - 1) // w) if value else 1
        assert num <= max_num_limbs
        limbs = decompose_big(value, num, w)
        cells = [self.mg.assign_constant(v) for v in limbs]
        zero = self.mg.assign_constant(0)
        cells += [zero] * (max_num_limbs - num)
        return AssignedInteger(cells, range_type)

    def assign_constant_fresh(self, value: int) -> AssignedInteger:
        return self._assign_constant(value, self.num_limbs, FRESH)

    def assign_constant_muled(self, value: int, n_l: int, n_r: int) -> AssignedInteger:
        return self._assign_constant(value, n_l + n_r - 1, MULED)

    def max_value(self, num_limbs: int) -> AssignedInteger:
        limb_max = (1 << self.limb_width) - 1
        cells = [self.mg.assign_constant(limb_max) for _ in range(num_limbs)]
        return AssignedInteger(cells, FRESH)

    # ---- refresh (chip.rs:171-236) ------------------------------------
    def refresh(self, a: AssignedInteger, aux: RefreshAux) -> AssignedInteger:
        assert self.limb_width == aux.limb_width
        assert a.num_limbs() == aux.num_limbs_l + aux.num_limbs_r - 1
        increased = aux.increased_limbs_vec
        num_fresh = len(increased)
        mg = self.mg
        zero = mg.assign_constant(0)
        limbs = [a.limb(i) for i in range(a.num_limbs())]
        limbs += [zero] * (num_fresh - len(limbs))
        limb_max = mg.assign_constant(1 << self.limb_width)
        for i in range(num_fresh):
            limb = limbs[i]
            for j in range(increased[i] + 1):
                q, r = self.div_mod_main_gate(limb, limb_max)
                if j == 0:
                    limbs[i] = r
                else:
                    limbs[i + j] = mg.add(limbs[i + j], r)
                limb = q
            mg.assert_zero(limb)
        out = []
        for i in range(num_fresh):
            ranged = self.rc.assign(
                limbs[i].value, self.sublimb_bit_len(self.limb_width), self.limb_width
            )
            mg.assert_equal(limbs[i], ranged)
            out.append(ranged)
        return AssignedInteger(out, FRESH)

    # ---- add / sub (chip.rs:248-376) ----------------------------------
    def add(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        w = self.limb_width
        mg, rc = self.mg, self.rc
        n1, n2 = a.num_limbs(), b.num_limbs()
        max_n = max(n1, n2)
        zero = mg.assign_constant(0)
        al = list(a.limbs) + [zero] * (max_n - n1)
        bl = list(b.limbs) + [zero] * (max_n - n2)
        limb_max_val = mg.assign_constant(1 << w)
        c_vals = []
        carries = [zero]
        for i in range(max_n):
            a_b = mg.add(al[i], bl[i])
            s = mg.add(a_b, carries[i])
            sv = s.value
            c_val = sv & ((1 << w) - 1)
            carry = sv >> w
            c = rc.assign(c_val, self.sublimb_bit_len(w), w)
            carry_c = rc.assign(carry, self.sublimb_bit_len(w), w)
            c_add_carry = mg.mul_add(carry_c, limb_max_val, c)
            mg.assert_equal(s, c_add_carry)
            c_vals.append(c)
            carries.append(carry_c)
        c_vals.append(carries[max_n])
        return AssignedInteger(c_vals, FRESH)

    def sub_unchecked(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        """chip.rs:1290-1322 (requires a >= b)."""
        w = self.limb_width
        assert a.num_limbs() >= b.num_limbs()
        max_n = a.num_limbs()
        a_big = a.to_big(w)
        b_big = b.to_big(w)
        c_big = a_big - b_big
        assert c_big >= 0, "sub_unchecked requires a >= b"
        cells = []
        for i in range(max_n):
            cells.append(
                self.rc.assign(
                    (c_big >> (w * i)) & ((1 << w) - 1), self.sublimb_bit_len(w), w
                )
            )
        c = AssignedInteger(cells, FRESH)
        added = self.add(b, c)
        self.assert_equal_fresh(a, added)
        return c

    def sub(self, a: AssignedInteger, b: AssignedInteger):
        """chip.rs:313-376: returns (|a-b| -ish, overflow_bit); if a>=b the
        result is a-b with bit 0, else b-a with bit 1."""
        mg = self.mg
        n2 = b.num_limbs()
        max_int = self.max_value(n2)
        inflated_a = self.add(a, max_int)
        inflated_subed = self.sub_unchecked(inflated_a, b)
        one = mg.assign_bit(1)
        is_not_overflowed = mg.is_equal(inflated_subed.limb(n2), one)
        is_overflowed = mg.not_(is_not_overflowed)

        num_limbs_l = inflated_subed.num_limbs()
        num_limbs_r = max(a.num_limbs(), n2)
        zero = mg.assign_constant(0)
        sel_l, sel_r = [], []
        for i in range(num_limbs_l):
            if i >= n2:
                val = mg.select(inflated_subed.limb(i), zero, is_not_overflowed)
            else:
                val = mg.select(inflated_subed.limb(i), b.limb(i), is_not_overflowed)
            sel_l.append(val)
        for i in range(num_limbs_r):
            if i >= a.num_limbs():
                val = mg.select(max_int.limb(i), zero, is_not_overflowed)
            elif i >= n2:
                val = mg.select(zero, a.limb(i), is_not_overflowed)
            else:
                val = mg.select(max_int.limb(i), a.limb(i), is_not_overflowed)
            sel_r.append(val)
        real_subed = self.sub_unchecked(
            AssignedInteger(sel_l, FRESH), AssignedInteger(sel_r, FRESH)
        )
        return real_subed, is_overflowed

    # ---- mul (chip.rs:389-440) ----------------------------------------
    def mul(self, a: AssignedInteger, b: AssignedInteger) -> AssignedInteger:
        d0, d1 = a.num_limbs(), b.num_limbs()
        d = d0 + d1 - 1
        mg = self.mg
        c_vals = []
        for i in range(d):
            acc = mg.assign_constant(0)
            j = 0 if d1 >= i + 1 else i + 1 - d1
            while j < d0 and j <= i:
                acc = mg.mul_add(a.limb(j), b.limb(i - j), acc)
                j += 1
            c_vals.append(acc)
        return AssignedInteger(c_vals, MULED)

    def square(self, a: AssignedInteger) -> AssignedInteger:
        return self.mul(a, a)

    # ---- modular ops (chip.rs:455-652) --------------------------------
    def add_mod(
        self, a: AssignedInteger, b: AssignedInteger, n: AssignedInteger
    ) -> AssignedInteger:
        added = self.add(a, b)
        subed, is_overflowed = self.sub(added, n)
        num_limbs = subed.num_limbs()
        zero = self.mg.assign_constant(0)
        added_l = list(added.limbs) + [zero] * (num_limbs - added.num_limbs())
        res = []
        for i in range(num_limbs):
            res.append(self.mg.select(added_l[i], subed.limb(i), is_overflowed))
        for i in range(n.num_limbs(), num_limbs):
            self.mg.assert_zero(res[i])
        return AssignedInteger(res[: n.num_limbs()], FRESH)

    def sub_mod(
        self, a: AssignedInteger, b: AssignedInteger, n: AssignedInteger
    ) -> AssignedInteger:
        subed1, is_overflowed1 = self.sub(a, b)
        subed2, is_overflowed2 = self.sub(n, subed1)
        self.mg.assert_zero(is_overflowed2)
        num_limbs = subed2.num_limbs()
        zero = self.mg.assign_constant(0)
        s1 = list(subed1.limbs) + [zero] * (num_limbs - subed1.num_limbs())
        res = []
        for i in range(num_limbs):
            res.append(self.mg.select(subed2.limb(i), s1[i], is_overflowed1))
        for i in range(n.num_limbs(), num_limbs):
            self.mg.assert_zero(res[i])
        return AssignedInteger(res[: n.num_limbs()], FRESH)

    def mul_mod(
        self, a: AssignedInteger, b: AssignedInteger, n: AssignedInteger
    ) -> AssignedInteger:
        w = self.limb_width
        n1, n2 = a.num_limbs(), b.num_limbs()
        assert n1 == n.num_limbs()
        a_big, b_big, n_big = a.to_big(w), b.to_big(w), n.to_big(w)
        full = a_big * b_big
        q_big, r_big = divmod(full, n_big)
        quotients = decompose_big(q_big, n2, w)
        prods = decompose_big(r_big, n1, w)
        sub_len = self.sublimb_bit_len(w)
        q_cells = [self.rc.assign(v, sub_len, w) for v in quotients]
        r_cells = [self.rc.assign(v, sub_len, w) for v in prods]
        quotient_int = AssignedInteger(q_cells, FRESH)
        prod_int = AssignedInteger(r_cells, FRESH)
        ab = self.mul(a, b)
        qn = self.mul(quotient_int, n)
        n_sum = n1 + n2
        eq_a, eq_b = [], []
        for i in range(n_sum - 1):
            eq_a.append(ab.limb(i))
            if i < n1:
                eq_b.append(self.mg.add(qn.limb(i), prod_int.limb(i)))
            else:
                eq_b.append(qn.limb(i))
        self.assert_equal_muled(
            AssignedInteger(eq_a, MULED), AssignedInteger(eq_b, MULED), n1, n2
        )
        return prod_int

    def square_mod(self, a: AssignedInteger, n: AssignedInteger) -> AssignedInteger:
        return self.mul_mod(a, a, n)

    def pow_mod(
        self,
        a: AssignedInteger,
        e: AssignedInteger,
        n: AssignedInteger,
        exp_limb_bits: int,
    ) -> AssignedInteger:
        """chip.rs:667-699: variable exponent square-and-multiply."""
        mg = self.mg
        e_bits = []
        for limb in e.limbs:
            e_bits.extend(mg.to_bits(limb, exp_limb_bits))
        acc = self.assign_constant_fresh(1)
        squared = a.clone()
        for e_bit in e_bits:
            muled = self.mul_mod(acc, squared, n)
            for j in range(acc.num_limbs()):
                sel = mg.select(muled.limb(j), acc.limb(j), e_bit)
                acc.replace_limb(j, sel)
            squared = self.square_mod(squared, n)
        return acc

    def pow_mod_fixed_exp(
        self, a: AssignedInteger, e: int, n: AssignedInteger
    ) -> AssignedInteger:
        """chip.rs:713-745: fixed exponent."""
        num_e_bits = self.bits_size(e)
        e_bits = [(e >> i) & 1 for i in range(num_e_bits)]
        acc = self._assign_constant(1, a.num_limbs(), FRESH)
        squared = a.clone()
        for bit in e_bits:
            cur_sq = squared
            squared = self.square_mod(cur_sq, n)
            if bit:
                acc = self.mul_mod(acc, cur_sq, n)
        return acc

    # ---- predicates (chip.rs:757-1009) --------------------------------
    def is_zero(self, a: AssignedInteger) -> Cell:
        mg = self.mg
        bit = mg.assign_bit(1)
        for limb in a.limbs:
            bit = mg.and_(bit, mg.is_zero(limb))
        return bit

    def is_equal_fresh(self, a: AssignedInteger, b: AssignedInteger) -> Cell:
        mg = self.mg
        n1, n2 = a.num_limbs(), b.num_limbs()
        is_a_larger = n1 > n2
        max_n = max(n1, n2)
        bit = mg.assign_bit(1)
        for i in range(max_n):
            if is_a_larger and i >= n2:
                flag = mg.is_zero(a.limb(i))
            elif not is_a_larger and i >= n1:
                flag = mg.is_zero(b.limb(i))
            else:
                flag = mg.is_equal(a.limb(i), b.limb(i))
            bit = mg.and_(bit, flag)
        return bit

    def is_equal_muled(
        self, a: AssignedInteger, b: AssignedInteger, n_l: int, n_r: int
    ) -> Cell:
        """EqualWhenCarried with carry range checks (chip.rs:825-898)."""
        mg, rc = self.mg, self.rc
        min_n = min(n_l, n_r)
        word_max = self.compute_mul_word_max(self.limb_width, min_n)
        w = self.limb_width
        num_limbs = n_l + n_r - 1
        word_max_width = (2 * word_max).bit_length()
        carry_bits = word_max_width - w
        limb_max = mg.assign_constant(1 << w)
        accumulated_extra = mg.assign_constant(0)
        carry = [mg.assign_constant(0)]
        cs = []
        eq_bit = mg.assign_bit(1)
        for i in range(num_limbs):
            a_b = mg.sub(a.limb(i), b.limb(i))
            s = mg.add_with_constant(a_b, carry[i], word_max)
            new_carry, c = self.div_mod_main_gate(s, limb_max)
            carry.append(new_carry)
            cs.append(c)
            accumulated_extra = mg.add_constant(accumulated_extra, word_max)
            q_acc, mod_acc = self.div_mod_main_gate(accumulated_extra, limb_max)
            cs_acc_eq = mg.is_equal(cs[i], mod_acc)
            eq_bit = mg.and_(eq_bit, cs_acc_eq)
            accumulated_extra = q_acc
            if i < num_limbs - 1:
                ranged = rc.assign(
                    carry[i + 1].value, self.sublimb_bit_len(carry_bits), carry_bits
                )
                range_eq = mg.is_equal(carry[i + 1], ranged)
                eq_bit = mg.and_(eq_bit, range_eq)
            else:
                final_eq = mg.is_equal(carry[i + 1], accumulated_extra)
                eq_bit = mg.and_(eq_bit, final_eq)
        return eq_bit

    def is_less_than(self, a: AssignedInteger, b: AssignedInteger) -> Cell:
        is_le = self.is_less_than_or_equal(a, b)
        is_eq = self.is_equal_fresh(a, b)
        return self.mg.and_(is_le, self.mg.not_(is_eq))

    def is_less_than_or_equal(self, a: AssignedInteger, b: AssignedInteger) -> Cell:
        _, is_overflowed = self.sub(a, b)
        return is_overflowed

    def is_greater_than(self, a: AssignedInteger, b: AssignedInteger) -> Cell:
        return self.mg.not_(self.is_less_than_or_equal(a, b))

    def is_greater_than_or_equal(self, a: AssignedInteger, b: AssignedInteger) -> Cell:
        return self.mg.not_(self.is_less_than(a, b))

    def is_in_field(self, a: AssignedInteger, n: AssignedInteger) -> Cell:
        return self.is_less_than(a, n)

    # ---- assertions ---------------------------------------------------
    def assert_zero(self, a: AssignedInteger) -> None:
        self.mg.assert_one(self.is_zero(a))

    def assert_equal_fresh(self, a: AssignedInteger, b: AssignedInteger) -> None:
        self.mg.assert_one(self.is_equal_fresh(a, b))

    def assert_equal_muled(
        self, a: AssignedInteger, b: AssignedInteger, n_l: int, n_r: int
    ) -> None:
        self.mg.assert_one(self.is_equal_muled(a, b, n_l, n_r))

    def assert_less_than(self, a, b) -> None:
        self.mg.assert_one(self.is_less_than(a, b))

    def assert_less_than_or_equal(self, a, b) -> None:
        self.mg.assert_one(self.is_less_than_or_equal(a, b))

    def assert_greater_than(self, a, b) -> None:
        self.mg.assert_one(self.is_greater_than(a, b))

    def assert_greater_than_or_equal(self, a, b) -> None:
        self.mg.assert_one(self.is_greater_than_or_equal(a, b))

    def assert_in_field(self, a, n) -> None:
        self.mg.assert_one(self.is_in_field(a, n))

    # ---- helpers ------------------------------------------------------
    def div_mod_main_gate(self, a: Cell, n: Cell):
        """chip.rs:1327-1353: witness (q, r) with a = n*q + r."""
        mg = self.mg
        av, nv = a.value, n.value
        q_val, r_val = divmod(av, nv)
        q = mg.assign_value(q_val)
        r = mg.assign_value(r_val % self.b.field.p)
        nq = mg.mul(n, q)
        a_sub_nq = mg.sub(a, nq)
        mg.assert_equal(r, a_sub_nq)
        return q, r

    def to_muled(self, a: AssignedInteger) -> AssignedInteger:
        zero = self.mg.assign_constant(0)
        limbs = list(a.limbs) + [zero] * (a.num_limbs() - 1)
        return AssignedInteger(limbs, MULED)


def big_pow_mod(a: int, b: int, n: int) -> int:
    """Native modpow (utils.rs:2-17)."""
    return pow(a, b, n)
