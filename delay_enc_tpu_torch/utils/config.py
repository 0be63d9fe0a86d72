"""Runtime configuration layer.

The reference has no config system — everything is compile-time const
generics (`<T, RATE, K>` at bench call sites, BITS_LEN/LIMB_WIDTH/
EXP_LIMB_BITS associated consts; SURVEY §5).  Here k, bit widths, exponent
windows, mesh shape and artifact paths are runtime choices, so they get a
real config object used by the bench script and servers.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field


@dataclass
class CircuitConfig:
    bits_len: int = 2048  # lib.rs:122
    limb_width: int = 64  # rsa/chip.rs:206
    exp_limb_bits: int = 5  # lib.rs:124
    t: int = 5
    rate: int = 4
    r_f: int = 8  # poseidon/chip.rs:24
    r_p: int = 57  # poseidon/chip.rs:26
    message_capacity: int = 2  # poseidon_enc.rs:10


@dataclass
class ProverConfig:
    k: int | None = None  # row-domain log2; None = derived from the circuit
    srs_cache_dir: str = "bench_data"
    key_cache_dir: str | None = None
    blinding_seed: int | None = None  # None = OS entropy


@dataclass
class MeshConfig:
    n_devices: int | None = None  # None = all visible devices
    axis: str = "shard"


@dataclass
class Config:
    circuit: CircuitConfig = field(default_factory=CircuitConfig)
    prover: ProverConfig = field(default_factory=ProverConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @staticmethod
    def from_json(path: str) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        return Config(
            circuit=CircuitConfig(**raw.get("circuit", {})),
            prover=ProverConfig(**raw.get("prover", {})),
            mesh=MeshConfig(**raw.get("mesh", {})),
        )

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(asdict(self), f, indent=2)

    @staticmethod
    def from_env(prefix: str = "DELAY_ENC_") -> "Config":
        cfg = Config()
        if os.environ.get(prefix + "K"):
            cfg.prover.k = int(os.environ[prefix + "K"])
        if os.environ.get(prefix + "SRS_DIR"):
            cfg.prover.srs_cache_dir = os.environ[prefix + "SRS_DIR"]
        if os.environ.get(prefix + "N_DEVICES"):
            cfg.mesh.n_devices = int(os.environ[prefix + "N_DEVICES"])
        return cfg
