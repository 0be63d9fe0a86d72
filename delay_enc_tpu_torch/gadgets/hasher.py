"""HasherChip: sponge-mode hashing over PoseidonChip.

Mirror of reference/src/hash/chip.rs: absorb in RATE chunks with
`perm_hash` (ONE padding lands on the first word past the final partial
chunk), plus an extra permutation when the last chunk is full
(chip.rs:63-86)."""

from __future__ import annotations

from ..cs import Builder, Cell
from ..poseidon.spec import Spec
from .poseidon_chip import PoseidonChip


class HasherChip:
    def __init__(self, builder: Builder, spec: Spec):
        self.pose_chip = PoseidonChip.new_hash(builder, spec)

    def update(self, elements: list[Cell]) -> None:
        self.pose_chip.absorbing.extend(elements)

    def hash(self) -> list[Cell]:
        rate = self.pose_chip.spec.rate
        inputs = self.pose_chip.absorbing
        self.pose_chip.absorbing = []
        padding_offset = 0
        for off in range(0, len(inputs), rate):
            chunk = inputs[off : off + rate]
            padding_offset = rate - len(chunk)
            self.pose_chip.perm_hash(chunk)
        if padding_offset == 0:
            self.pose_chip.perm_hash([])
        return list(self.pose_chip.state)
