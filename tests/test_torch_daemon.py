"""The port's warm prover daemon (delay_enc_tpu_torch/runtime/daemon.py) on
the CPU.

The protocol cases of tests/test_daemon.py run against the port's daemon
with its `stub` workload (no device work), each through the port's client
and through the JAX package's (`delay_enc_tpu.runtime.client`, pure host
code): the two speak one protocol.  Then the settings that replace the
JAX daemon's environment variables, the warmup's selfcheck level, and real
k=7 proofs and a batch served through the daemon's job path, whose bytes
equal the JAX package's goldens.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_prover import GOLDEN, K, SEED, TAU, _build_circuit, one_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_batch_k7.npz")


def _start(sock: str, warm: str, *extra) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, "-m", "delay_enc_tpu_torch.runtime.daemon", "--warm", warm,
         "--socket", sock, "--srs-dir", os.path.dirname(sock), "--device", "cpu", *extra],
        cwd=ROOT, env=env, stderr=subprocess.DEVNULL)


def _wait_warm(request_fn, sock: str, key: str, seconds: float = 90):
    deadline = time.time() + seconds
    st = None
    while time.time() < deadline:
        st = request_fn({"cmd": "ping"}, socket_path=sock)
        if st and key in st.get("warm", []):
            return st
        time.sleep(0.2)
    raise AssertionError(f"daemon never warmed {key}: {st}")


def _stop(request_fn, sock: str, proc: subprocess.Popen) -> int:
    request_fn({"cmd": "shutdown"}, socket_path=sock)
    try:
        return proc.wait(20)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise


@pytest.fixture(params=["port", "jax"])
def client(request):
    """daemon_request of either package."""
    if request.param == "port":
        from delay_enc_tpu_torch.runtime import daemon_request
    else:
        from delay_enc_tpu.runtime.client import daemon_request
    return daemon_request


@pytest.fixture(scope="module")
def stub_daemon(tmp_path_factory):
    from delay_enc_tpu_torch.runtime import daemon_request

    sock = str(tmp_path_factory.mktemp("daemon") / "d.sock")
    proc = _start(sock, "stub")
    try:
        _wait_warm(daemon_request, sock, "stub:0")
        yield sock
    finally:
        assert _stop(daemon_request, sock, proc) == 0


def test_ping_status(stub_daemon, client):
    st = client({"cmd": "ping"}, socket_path=stub_daemon)
    assert st["ok"] and st["warm"] == ["stub:0"]
    assert st["queued"] == 0 and st["uptime_s"] >= 0
    assert st["device"] == "cpu" and st["failed_warm"] == {}


def test_prove_streams_events(stub_daemon, client):
    evs = []
    fin = client({"cmd": "prove", "workload": "stub", "k": 0, "repeats": 3, "budget_s": 30},
                 on_event=evs.append, timeout=30, socket_path=stub_daemon)
    assert fin["event"] == "done" and fin["repeats"] == 3
    assert [e["i"] for e in evs] == [1, 2, 3]
    assert bytes.fromhex(fin["proof_hex"]) == b"stub"


def test_not_warm_is_error_with_status(stub_daemon, client):
    fin = client({"cmd": "prove", "workload": "delay_enc", "k": 16}, socket_path=stub_daemon)
    assert fin["event"] == "error" and "not warm" in fin["error"]
    assert fin["warm"] == ["stub:0"]


def test_unknown_cmd(stub_daemon, client):
    fin = client({"cmd": "nonsense"}, socket_path=stub_daemon)
    assert fin["event"] == "error"


@pytest.mark.parametrize("req", [{"cmd": "prove", "workload": "stub", "k": "zero"},
                                 {"cmd": "prove", "workload": "stub", "k": 0, "env": [1]},
                                 {"cmd": "batch", "k": 0, "b": 4, "budget_s": "soon"},
                                 {"cmd": "set_warm", "warm": "stub:0,batch"},
                                 {"cmd": "setenv", "env": "DELAY_ENC_MSM=b16"}],
                         ids=["k", "env", "budget", "set_warm", "setenv"])
def test_malformed_request_is_error(stub_daemon, client, req):
    """A request the daemon cannot read is answered with an error, and the
    daemon serves on."""
    fin = client(req, socket_path=stub_daemon)
    assert fin["event"] == "error"
    st = client({"cmd": "ping"}, socket_path=stub_daemon)
    assert st["ok"] and st["busy"] is None


def test_absent_daemon_returns_none(tmp_path, client):
    assert client({"cmd": "ping"}, socket_path=str(tmp_path / "nope.sock")) is None


def test_set_warm_replaces_pending(stub_daemon, client):
    st = client({"cmd": "set_warm", "warm": "stub:0"}, socket_path=stub_daemon)
    assert st["ok"] and st["pending_warm"] == []
    st = client({"cmd": "ping"}, socket_path=stub_daemon)
    assert st["warm"] == ["stub:0"]


def test_setenv_flips_tuning_flags_only(stub_daemon, client):
    """DELAY_ENC_* keys are applied to the daemon's settings (the MSM base
    here), other keys ignored; null restores the command line's value.  The
    process environment is never written."""
    st = client({"cmd": "setenv", "env": {"DELAY_ENC_MSM": "b16", "HOME": "/pwned"}},
                socket_path=stub_daemon)
    assert st["ok"] and st["applied"] == {"DELAY_ENC_MSM": "b16"}
    assert st["settings"]["msm"] == "b16"
    st = client({"cmd": "setenv", "env": {"DELAY_ENC_MSM": None}}, socket_path=stub_daemon)
    assert st["applied"] == {"DELAY_ENC_MSM": None} and st["settings"]["msm"] == "b4"


def test_request_env_is_the_request_alone(stub_daemon, client):
    """A prove's `env` overlay holds for that request: the done event names
    its MSM base, and the daemon's settings stay as they were."""
    fin = client({"cmd": "prove", "workload": "stub", "k": 0, "repeats": 1,
                  "env": {"DELAY_ENC_MSM": "b16", "PATH": "/pwned"}}, socket_path=stub_daemon)
    assert fin["event"] == "done" and fin["msm"] == "b16"
    st = client({"cmd": "ping"}, socket_path=stub_daemon)
    assert st["settings"] == {"msm": "b4", "selfcheck": None, "ntt": "stockham"}


def test_serves_warm_key_while_warming(tmp_path):
    """A prove for a warm key does not wait for a warm in flight: stub:1
    takes 5 s to warm, and stub:0's proofs, asked through either package's
    client, return while it warms."""
    from delay_enc_tpu.runtime.client import daemon_request as jax_request
    from delay_enc_tpu_torch.runtime import daemon_request

    sock = str(tmp_path / "d.sock")
    proc = _start(sock, "stub:0,stub:1", "--stub-warm-s", "5")
    try:
        st = _wait_warm(daemon_request, sock, "stub:0", seconds=60)
        assert st.get("serves_while_warming") is True
        assert st.get("warming") == "stub:1" or "stub:1" in st.get("pending_warm", [])
        t0 = time.time()
        for client in (daemon_request, jax_request):
            fin = client({"cmd": "prove", "workload": "stub", "k": 0, "repeats": 1,
                          "budget_s": 10}, timeout=15, socket_path=sock)
            assert fin and fin.get("event") == "done", f"prove failed: {fin}"
        dt = time.time() - t0
        st = daemon_request({"cmd": "ping"}, socket_path=sock)
        assert "stub:1" not in st["warm"], f"the proves waited for the warm ({dt:.1f} s)"
        _wait_warm(daemon_request, sock, "stub:1", seconds=30)
    finally:
        assert _stop(daemon_request, sock, proc) == 0


@pytest.mark.parametrize("value,level", [("0", 0), ("1", 1), ("2", 2), ("7", 2), ("", 0),
                                         ("yes", 1), (None, None)])
def test_selfcheck_setting(value, level):
    """DELAY_ENC_SELFCHECK as the JAX package reads it; the warmup checks
    its commitments unless a level was set, and an explicit 0 wins."""
    from delay_enc_tpu_torch.runtime.daemon import apply_env, warmup_level

    defaults = {"msm": "b4", "selfcheck": None}
    settings = dict(defaults, selfcheck=2)
    applied = apply_env(settings, {"DELAY_ENC_SELFCHECK": value, "DELAY_ENC_X": "1", "Y": 2},
                        defaults)
    assert applied == {"DELAY_ENC_SELFCHECK": value, "DELAY_ENC_X": "1"}
    assert settings == {"msm": "b4", "selfcheck": level}
    assert warmup_level(settings) == (1 if level is None else level)


@pytest.mark.parametrize("setting,want", [(None, 1), (0, 0), (2, 2)])
def test_warm_one_runs_selfcheck_wiring(monkeypatch, tmp_path, setting, want):
    """_warm_one's warmup create_proof gets the warmup level, the command
    line's MSM base and NTT, and the key directory's artifact."""
    from delay_enc_tpu_torch import plonk as P
    from delay_enc_tpu_torch.runtime import daemon as D
    from delay_enc_tpu_torch.runtime import workloads as W

    seen = {}

    class _B:
        instance = []

    monkeypatch.setattr(W, "build_circuit", lambda wl, k=None, seed=42: _B())
    monkeypatch.setattr(W, "get_keys", lambda wl, b, srs, k, cache, msm, device:
                        ("pk", "vk", os.path.join(cache, "kp")))
    monkeypatch.setattr(W, "save_proof_artifact",
                        lambda *a: seen.setdefault("artifact", a))
    monkeypatch.setattr(P.SRS, "setup", staticmethod(lambda k, device, cache_dir: "srs"))
    monkeypatch.setattr(D.Daemon, "_prepare", lambda self, e, msm, ntt: None)

    def fake_create_proof(srs, pk, builder, rng, device, msm, selfcheck, checks, ntt):
        seen.update(selfcheck=selfcheck, msm=msm, ntt=ntt)
        checks.append(("advice[0]", True))
        return b"proof"

    monkeypatch.setattr(P, "create_proof", fake_create_proof)
    monkeypatch.setattr(P, "verify_proof", lambda *a, **kw: True)
    e = D.WarmEntry("pose_enc", 11)
    d = D.Daemon([], socket_path=str(tmp_path / "unused.sock"), srs_dir=str(tmp_path),
                 device="cpu", msm="b16", selfcheck=setting)
    d._warm_one(e)
    assert seen["selfcheck"] == want and seen["msm"] == "b16" and seen["ntt"] == "stockham"
    assert e.selfcheck == {"ok": 1, "mismatch": [], "skipped": 0}
    assert seen["artifact"][:4] == (str(tmp_path), "pose_enc", 11, os.path.join(str(tmp_path), "kp"))
    assert e.warmup_s is not None and "warm/proof" in e.spans


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A daemon on the CPU (not listening) with two warm entries of the
    test circuit: one proof ("k7", the golden's statement at its k=5) and a
    batch of the JAX batch golden's two witnesses."""
    from delay_enc_tpu_torch import cs
    from delay_enc_tpu_torch.fields import FR
    from delay_enc_tpu_torch.plonk import SRS, keygen
    from delay_enc_tpu_torch.runtime import daemon as D

    srs = SRS.setup(K, tau=TAU, device="cpu")
    b = _build_circuit(cs, FR)
    pk, vk = keygen(b, srs, device="cpu")
    k = vk.domain.k
    d = D.Daemon([], socket_path=str(tmp_path_factory.mktemp("d") / "unused.sock"),
                 srs_dir="", device="cpu")
    one, batch = D.WarmEntry("k7", k), D.WarmEntry("batch", k, 2)
    with np.load(BATCH_GOLDEN) as z:
        batch.builders = [_build_circuit(cs, FR, *(int(v) for v in w)) for w in z["witnesses"]]
        want_batch, batch_seed = [p.tobytes() for p in z["proofs"]], int(z["seed"])
    one.builders = [b]
    for e in (one, batch):
        e.srs, e.pk, e.vk, e.warmup_s = srs, pk, vk, 0.0
        d.entries[e.key] = e
        d.warm.append(e.key)
    with np.load(GOLDEN) as z:
        want = z["proof"].tobytes()
    return d, k, want, want_batch, batch_seed


def _job(d, req) -> list:
    """Run one request on the daemon's job path; its event lines."""
    ours, theirs = socket.socketpair()
    with ours, theirs:
        d._run_job(ours, req)
        data = b""
        while chunk := theirs.recv(1 << 20):
            data += chunk
    return [json.loads(line) for line in data.decode().splitlines()]


def test_served_proof_is_golden(served):
    d, k, want, _, _ = served
    evs = _job(d, {"cmd": "prove", "workload": "k7", "k": k, "seed": SEED, "repeats": 2})
    *repeats, fin = evs
    assert [e["event"] for e in repeats] == ["repeat", "repeat"]
    assert all(e["seed"] == SEED and "prove/advice commit" in e["phases_s"] for e in repeats)
    assert fin["event"] == "done" and fin["verified"] is True and fin["repeats"] == 2
    assert bytes.fromhex(fin["proof_hex"]) == want and fin["msm"] == "b4"
    assert "selfcheck" not in fin and d.busy is None


def test_served_proof_b16_with_selfcheck(served):
    """A request's env picks base 16 and selfcheck level 2 for itself: the
    same golden bytes, every check ok."""
    d, k, want, _, _ = served
    fin = _job(d, {"cmd": "prove", "workload": "k7", "k": k, "seed": SEED, "repeats": 1,
                   "env": {"DELAY_ENC_MSM": "b16", "DELAY_ENC_SELFCHECK": "2"}})[-1]
    assert fin["event"] == "done" and fin["verified"] is True and fin["msm"] == "b16"
    assert bytes.fromhex(fin["proof_hex"]) == want
    assert fin["selfcheck"] == {"ok": 29 + 3, "mismatch": [], "skipped": 0}
    assert d.settings == {"msm": "b4", "selfcheck": None, "ntt": "stockham"}


def test_served_proof_mxu(served):
    """DELAY_ENC_NTT=mxu in a request's env sends that proof's transforms
    through the matmul NTT: the same golden bytes; the settings stay."""
    d, k, want, _, _ = served
    fin = _job(d, {"cmd": "prove", "workload": "k7", "k": k, "seed": SEED, "repeats": 1,
                   "env": {"DELAY_ENC_NTT": "mxu"}})[-1]
    assert fin["event"] == "done" and fin["verified"] is True and fin["ntt"] == "mxu"
    assert bytes.fromhex(fin["proof_hex"]) == want
    assert d.settings["ntt"] == "stockham"


def test_served_batch_is_jax_batch(served):
    d, k, _, want_batch, seed = served
    *repeats, fin = _job(d, {"cmd": "batch", "k": k, "b": 2, "seed": seed, "repeats": 1})
    assert [e["event"] for e in repeats] == ["repeat"] and repeats[0]["proofs_per_s"] > 0
    assert fin["event"] == "done" and fin["verified"] is True and fin["b"] == 2
    assert bytes.fromhex(fin["proof_hex"]) == want_batch[0]


def test_collect_keeps_threads_apart():
    """Metrics.collect gives each thread its own spans while every add also
    reaches the shared ones: 16 threads, a short switch interval, and no
    add lost or crossed."""
    import threading

    from delay_enc_tpu_torch.utils.timers import Metrics

    m, sinks, adds = Metrics(), {}, 500
    interval = sys.getswitchinterval()

    def work(i: int):
        with m.collect() as mine:
            for _ in range(adds):
                m.add(f"t{i % 4}", 1.0)
                m.add("all", 1.0)
        sinks[i] = mine

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert all(sinks[i] == {f"t{i % 4}": adds, "all": adds} for i in range(16))
    assert m.snapshot() == {**{f"t{j}": 4.0 * adds for j in range(4)}, "all": 16.0 * adds}
