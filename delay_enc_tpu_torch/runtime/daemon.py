"""Warm prover daemon: one long-lived process that keeps the proving stack
resident on the card (the loaded kernels, SRS, proving keys, pair tables
and NTT plans) and serves proofs over a unix socket.

Counterpart of `delay_enc_tpu/runtime/daemon.py`, with the same protocol
(see runtime/client.py).  A proving service pays its cold start once: SRS
setup, keygen (or a key read from the cache) and a warmup proof per
statement, then each request's proof alone; the reference's own benchmark
times the same warm regime (benches/delay_enc.rs:121-133).

Run:  python -m delay_enc_tpu_torch.runtime.daemon \\
          --warm pose_enc:11,delay_enc:16,batch:16:4 --socket S \\
          --srs-dir D [--key-dir D] [--device cuda|cpu] \\
          [--selfcheck auto|0|1|2] [--msm b4|b16] [--stub-warm-s X]

Protocol (newline-delimited JSON):
  {"cmd": "ping"} -> {"ok": true, "warm": [...], "warming": ..., "busy": ...}
  {"cmd": "set_warm", "warm": "delay_enc:16,batch:16:4"} -> status
  {"cmd": "setenv", "env": {"DELAY_ENC_MSM": "b16"}} -> status + "applied"
  {"cmd": "prove", "workload": "delay_enc", "k": 16, "repeats": 3,
   "seed": 7, "budget_s": 600, "env": {...}}
      -> {"event": "repeat", "i": 1, "seconds": ..., "phases_s": {...}} ...
      -> {"event": "done", "best_s": ..., "repeats": N, "proof_hex": ...,
          "vk_path": ..., "verified": true}
  {"cmd": "batch", "k": 16, "b": 4, "repeats": 2, "budget_s": 600}
      -> {"event": "repeat", "i": 1, "seconds": S, "proofs_per_s": ...} ...
      -> {"event": "done", "best_s": ..., "proofs_per_s": ..., "verified": true}
  {"cmd": "shutdown"} -> {"event": "done"}

Where it differs from the JAX daemon:
 - it reads no environment variable.  `setenv` and a request's `env` write
   the daemon's settings: DELAY_ENC_MSM (b4 | b16) picks the MSM base,
   DELAY_ENC_NTT (mxu, anything else stockham) the transforms' kernel of
   single proofs (batches keep K-b, as the JAX batch prover has no matmul
   NTT), DELAY_ENC_SELFCHECK the host-oracle level (plonk/selfcheck.py);
   other DELAY_ENC_* keys are echoed under "applied" and change nothing,
   other keys are ignored.  A null value restores the command line's
   setting (stockham for the NTT);
 - `batch:k:b` proves b builds of seed 42's statement under the
   `delay_enc:k` key.  The JAX daemon, like bench.py's batch, draws seeds
   100..100+b-1: four puzzles, each a circuit of its own, so under the first
   one's key only the first proof verifies;
 - the warmup proof of a non-batch entry runs the commitment selfcheck
   (level 1) unless a level was set, an explicit 0 included; a warmup proof
   that fails to verify is saved in the key directory;
 - ping also reports the settings, the warm entries' seconds and spans,
   failed warms and, on a card, the peak device memory and the launch
   counts of the hand kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import queue
import socket
import sys
import threading
import time
import traceback


def _log(msg: str) -> None:
    print(f"# daemon {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def selfcheck_level(value) -> int:
    """A DELAY_ENC_SELFCHECK value as the JAX package reads it: empty is 0,
    a number >= 2 is 2, another nonzero number or text is 1."""
    try:
        level = int(str(value) or "0")
    except ValueError:
        return 1
    return 0 if level == 0 else (2 if level >= 2 else 1)


def apply_env(settings: dict, env: dict, defaults: dict) -> dict:
    """Apply DELAY_ENC_* keys of `env` to `settings` in place; returns what
    was applied.  None restores the default."""
    applied = {}
    for key, value in env.items():
        if not str(key).startswith("DELAY_ENC"):
            continue
        applied[key] = value
        if key == "DELAY_ENC_MSM":
            settings["msm"] = defaults["msm"] if value is None else (
                "b16" if str(value) == "b16" else "b4")
        elif key == "DELAY_ENC_NTT":
            settings["ntt"] = defaults["ntt"] if value is None else (
                "mxu" if str(value) == "mxu" else "stockham")
        elif key == "DELAY_ENC_SELFCHECK":
            settings["selfcheck"] = defaults["selfcheck"] if value is None else \
                selfcheck_level(value)
    return applied


def warmup_level(settings: dict) -> int:
    """The warmup proof checks its commitments (level 1) unless a level was
    set; an explicit 0 wins."""
    return 1 if settings["selfcheck"] is None else settings["selfcheck"]


def _tally(checks: list) -> dict:
    """Counts of a proof's selfcheck results."""
    return {"ok": sum(ok is True for _, ok in checks),
            "mismatch": [label for label, ok in checks if ok is False],
            "skipped": sum(ok is None for _, ok in checks)}


class WarmEntry:
    def __init__(self, workload: str, k: int, b: int | None = None):
        self.workload, self.k, self.b = workload, k, b
        self.builders = None  # [Builder] (b of them for batch)
        self.srs = self.pk = self.vk = None
        self.key_path = ""
        self.warmup_s = None
        self.spans: dict = {}  # the warm's spans (SRS, keys, warmup proof)
        self.selfcheck = None  # the warmup proof's selfcheck tally
        self.seed = 1000  # requests without a seed draw from here on

    @property
    def key(self) -> str:
        return (f"batch:{self.k}:{self.b}" if self.workload == "batch"
                else f"{self.workload}:{self.k}")


def parse_warm(spec: str) -> list[WarmEntry]:
    out = []
    for part in filter(None, (s.strip() for s in spec.split(","))):
        bits = part.split(":")
        if bits[0] == "batch":
            out.append(WarmEntry("batch", int(bits[1]), int(bits[2]) if len(bits) > 2 else 4))
        elif bits[0] == "stub":  # protocol tests: no device, an instant "proof"
            out.append(WarmEntry("stub", int(bits[1]) if len(bits) > 1 else 0))
        else:
            out.append(WarmEntry(bits[0], int(bits[1])))
    return out


class Daemon:
    def __init__(self, warm_specs: list[WarmEntry], socket_path: str, srs_dir: str,
                 key_dir: str | None = None, device="cuda", msm: str = "b4",
                 selfcheck: int | None = None, stub_warm_s: float = 0.0):
        from ..utils.device import resolve

        self.entries: dict[str, WarmEntry] = {e.key: e for e in warm_specs}
        self.pending = [e.key for e in warm_specs]
        self.socket_path = socket_path
        self.srs_dir = srs_dir
        self.key_dir = key_dir or srs_dir
        self.device = resolve(device)
        self.defaults = {"msm": msm, "selfcheck": selfcheck, "ntt": "stockham"}
        self.settings = dict(self.defaults)
        self.stub_warm_s = stub_warm_s
        self.state_lock = threading.Lock()
        # the lazy state that proofs share (pair tables, NTT plans) is built
        # under this lock, never by two threads at once
        self.prep_lock = threading.Lock()
        self.warm: list[str] = []
        self.failed: dict[str, str] = {}
        self.warming: str | None = None
        self.busy: str | None = None
        self.jobs: "queue.Queue[tuple[socket.socket, dict]]" = queue.Queue()
        self.t0 = time.time()
        self._stop = False
        self._local = threading.local()

    # ------------------------------------------------------------ server
    def _status(self) -> dict:
        with self.state_lock:
            st = {"ok": True, "warm": list(self.warm), "warming": self.warming,
                  "pending_warm": list(self.pending), "busy": self.busy,
                  "uptime_s": round(time.time() - self.t0, 1),
                  "queued": self.jobs.qsize(),
                  # jobs for warm keys run on their own thread, beside the warm
                  "serves_while_warming": True,
                  "device": str(self.device), "settings": dict(self.settings),
                  "failed_warm": dict(self.failed),
                  "warm_s": {key: self.entries[key].warmup_s for key in self.warm},
                  "warm_spans": {key: self.entries[key].spans for key in self.warm},
                  "warm_selfcheck": {key: self.entries[key].selfcheck for key in self.warm}}
        if self.device.type == "cuda":
            import torch

            from ..ops import _cuda

            st["device_peak_bytes"] = torch.cuda.max_memory_allocated(self.device)
            st["launches"] = _cuda.launch_counts()
        return st

    def _serve_thread(self, srv: socket.socket):
        _log(f"listening on {self.socket_path}")
        while not self._stop:
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            threading.Thread(target=self._handle_conn, args=(conn,), daemon=True).start()
        srv.close()

    def _handle_conn(self, conn: socket.socket):
        try:
            conn.settimeout(30.0)
            buf = b""
            while b"\n" not in buf:
                chunk = conn.recv(65536)
                if not chunk:
                    conn.close()
                    return
                buf += chunk
            req = json.loads(buf.split(b"\n", 1)[0].decode())
        except (OSError, json.JSONDecodeError, UnicodeDecodeError):
            conn.close()
            return
        if not isinstance(req, dict):
            conn.close()
            return
        cmd = req.get("cmd")
        try:
            if cmd == "ping":
                reply = self._status()
            elif cmd == "set_warm":
                # replace the pending warm list (the entry in flight finishes)
                new = parse_warm(str(req.get("warm", "")))
                with self.state_lock:
                    for e in new:
                        self.entries.setdefault(e.key, e)
                    self.pending[:] = [e.key for e in new if e.key not in self.warm]
                reply = self._status()
            elif cmd == "setenv":
                env = req.get("env") or {}
                if not isinstance(env, dict):
                    raise TypeError(f"env is {type(env).__name__}, not an object")
                with self.state_lock:
                    applied = apply_env(self.settings, env, self.defaults)
                _log(f"setenv {applied}")
                reply = dict(self._status(), applied=applied)
            else:
                # streaming commands run on the job thread
                self.jobs.put((conn, req))
                return
        except (ValueError, IndexError, TypeError) as ex:  # a malformed request
            reply = {"event": "error", "error": repr(ex)}
        try:
            _send(conn, reply)
        except OSError:
            pass
        conn.close()

    @contextlib.contextmanager
    def _stream(self):
        """The calling thread's own CUDA stream (none on the CPU): the warm
        thread's kernels and the job thread's run side by side."""
        if self.device.type != "cuda":
            yield
            return
        import torch

        if not hasattr(self._local, "stream"):
            self._local.stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._local.stream):
            yield

    def _prepare(self, e: WarmEntry, msm: str, ntt: str = "stockham") -> None:
        from ..plonk.pipeline import _prepare

        with self.prep_lock:
            _prepare(e.srs, e.pk, self.device, msm, ntt)

    # ------------------------------------------------------------ warming
    def _warm_one(self, e: WarmEntry) -> None:
        t0 = time.time()
        if e.workload == "stub":
            # protocol tests: a warm of stub_warm_s seconds for stub:k, k > 0
            time.sleep(self.stub_warm_s if e.k else 0.0)
            e.warmup_s = time.time() - t0
            _log(f"warm {e.key}: stub ready")
            return
        import numpy as np

        from ..plonk import SRS, create_proof, create_proofs_batched, verify_proof
        from ..utils.device import sync_stream
        from ..utils.timers import GLOBAL_METRICS
        from . import workloads as W

        with self.state_lock:
            s = dict(self.settings)
        dev = self.device
        wl = "delay_enc" if e.workload == "batch" else e.workload
        with GLOBAL_METRICS.collect() as spans, self._stream():
            with GLOBAL_METRICS.span("warm/circuits"):
                # a batch is b builds of seed 42's statement: a delay_enc
                # circuit has one witness (module docstring)
                e.builders = [W.build_circuit(wl, k=e.k) for _ in range(e.b or 1)]
            with GLOBAL_METRICS.span("warm/srs", dev):
                e.srs = SRS.setup(e.k, device=dev, cache_dir=self.srs_dir)
            e.pk, e.vk, e.key_path = W.get_keys(wl, e.builders[0], e.srs, e.k, self.key_dir,
                                                msm=s["msm"], device=dev)
            _log(f"warm {e.key}: keys ready {time.time() - t0:.1f}s, warmup proof")
            single_ntt = "stockham" if e.workload == "batch" else s["ntt"]
            self._prepare(e, s["msm"], single_ntt)
            with GLOBAL_METRICS.span("warm/proof", dev):
                if e.workload == "batch":
                    proofs = create_proofs_batched(e.srs, e.pk, e.builders,
                                                   np.random.default_rng(0), device=dev,
                                                   msm=s["msm"])
                else:
                    checks = []
                    proofs = [create_proof(e.srs, e.pk, e.builders[0], np.random.default_rng(0),
                                           device=dev, msm=s["msm"], selfcheck=warmup_level(s),
                                           checks=checks, ntt=s["ntt"])]
                    e.selfcheck = _tally(checks)
            ok = all(verify_proof(e.srs, e.vk, pf, instances=b.instance)
                     for pf, b in zip(proofs, e.builders))
            if not ok:
                # keep serving (each answer carries verified=false), and keep
                # the failing bytes as evidence
                path = os.path.join(self.key_dir, f"failed_proof_{e.key.replace(':', '_')}.bin")
                with open(path, "wb") as f:
                    f.write(proofs[0])
                _log(f"warm {e.key}: WARMUP PROOF FAILED VERIFY, saved {path}")
            elif e.workload != "batch":
                W.save_proof_artifact(self.key_dir, wl, e.k, e.key_path, proofs[0], self.srs_dir)
            sync_stream(dev)  # the key is whole before another stream reads it
        e.spans = {name: round(v, 4) for name, v in spans.items()}
        e.warmup_s = time.time() - t0
        _log(f"warm {e.key}: done in {e.warmup_s:.1f}s (verified={ok}); spans "
             f"{json.dumps(e.spans)}; selfcheck {json.dumps(e.selfcheck)}")

    # ------------------------------------------------------------- jobs
    def _run_prove(self, conn, req, e: WarmEntry, s: dict, t_end: float):
        times, proof, checks = [], b"", []
        level = s["selfcheck"] or 0
        if e.workload != "stub":
            import numpy as np

            from ..plonk import create_proof, verify_proof
            from ..utils.timers import GLOBAL_METRICS

            self._prepare(e, s["msm"], s["ntt"])
        for i in range(max(1, int(req.get("repeats", 2)))):
            if times and time.time() + 1.5 * times[-1] + 10 > t_end:
                break
            if e.workload == "stub":
                time.sleep(0.01)
                times.append(0.01)
                proof = b"stub"
                _send(conn, {"event": "repeat", "i": i + 1, "seconds": 0.01})
                continue
            e.seed += 1
            seed = int(req["seed"]) if "seed" in req else e.seed
            checks = []
            with GLOBAL_METRICS.collect() as spans:
                t0 = time.time()
                proof = create_proof(e.srs, e.pk, e.builders[0], np.random.default_rng(seed),
                                     device=self.device, msm=s["msm"], selfcheck=level,
                                     checks=checks, ntt=s["ntt"])
                times.append(time.time() - t0)
            _send(conn, {"event": "repeat", "i": i + 1, "seconds": round(times[-1], 4),
                         "seed": seed, "phases_s": {nm: round(v, 4) for nm, v in spans.items()}})
        verified = None
        if e.workload != "stub":
            verified = bool(verify_proof(e.srs, e.vk, proof, instances=e.builders[0].instance))
        done = {"event": "done", "best_s": round(min(times), 4), "repeats": len(times),
                "verified": verified, "warmup_s": e.warmup_s, "vk_path": e.key_path,
                "msm": s["msm"], "ntt": s["ntt"], "proof_hex": proof.hex()}
        if level:
            done["selfcheck"] = _tally(checks)
        _send(conn, done)

    def _run_batch(self, conn, req, e: WarmEntry, s: dict, t_end: float):
        import numpy as np

        from ..plonk import create_proofs_batched, verify_proof
        from ..utils.timers import GLOBAL_METRICS

        self._prepare(e, s["msm"])
        times, proofs = [], []
        for i in range(max(1, int(req.get("repeats", 2)))):
            if times and time.time() + 1.5 * times[-1] + 10 > t_end:
                break
            e.seed += 1
            seed = int(req["seed"]) if "seed" in req else e.seed
            with GLOBAL_METRICS.collect() as spans:
                t0 = time.time()
                proofs = create_proofs_batched(e.srs, e.pk, e.builders,
                                               np.random.default_rng(seed), device=self.device,
                                               msm=s["msm"])
                times.append(time.time() - t0)
            _send(conn, {"event": "repeat", "i": i + 1, "seconds": round(times[-1], 4),
                         "proofs_per_s": round(e.b / times[-1], 4), "seed": seed,
                         "phases_s": {nm: round(v, 4) for nm, v in spans.items()}})
        verified = all(verify_proof(e.srs, e.vk, pf, instances=b.instance)
                       for pf, b in zip(proofs, e.builders))
        _send(conn, {"event": "done", "best_s": round(min(times), 4), "repeats": len(times),
                     "b": e.b, "proofs_per_s": round(e.b / min(times), 4),
                     "verified": bool(verified), "warmup_s": e.warmup_s, "vk_path": e.key_path,
                     "msm": s["msm"], "proof_hex": proofs[0].hex() if proofs else ""})

    def _run_job(self, conn, req):
        cmd = req.get("cmd")
        if cmd == "shutdown":
            _send(conn, {"event": "done"})
            conn.close()
            self._stop = True
            return
        if cmd == "prove":
            key = f"{req.get('workload', 'delay_enc')}:{int(req.get('k', 16))}"
        elif cmd == "batch":
            key = f"batch:{int(req.get('k', 16))}:{int(req.get('b', 4))}"
        else:
            _send(conn, {"event": "error", "error": f"unknown cmd {cmd!r}"})
            conn.close()
            return
        env = req.get("env") or {}
        if not isinstance(env, dict):
            raise TypeError(f"env is {type(env).__name__}, not an object")
        t_end = time.time() + float(req.get("budget_s", 300.0))
        with self.state_lock:
            is_warm = key in self.warm
            if is_warm:
                self.busy = key
            s = dict(self.settings)
            apply_env(s, env, self.defaults)
        if not is_warm:
            _send(conn, {"event": "error", "error": f"{key} not warm", **self._status()})
            conn.close()
            return
        e = self.entries[key]
        try:
            with self._stream():
                if cmd == "batch":
                    self._run_batch(conn, req, e, s, t_end)
                else:
                    self._run_prove(conn, req, e, s, t_end)
        except BrokenPipeError:
            _log(f"client gone mid-{cmd} ({key})")
        except Exception as ex:  # report, stay alive
            _log(f"job {key} failed: {ex!r}\n{traceback.format_exc()}")
            try:
                _send(conn, {"event": "error", "error": repr(ex)})
            except OSError:
                pass
        finally:
            with self.state_lock:
                self.busy = None
            try:
                conn.close()
            except OSError:
                pass

    # ------------------------------------------------------------- main
    def _job_thread(self):
        """Serve prove and batch jobs for warm keys beside the warm on the
        main thread, so a long warm never starves a warm key's requests."""
        while not self._stop:
            try:
                conn, req = self.jobs.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                self._run_job(conn, req)
            except (ValueError, TypeError) as ex:  # a malformed request: answer, stay alive
                try:
                    _send(conn, {"event": "error", "error": repr(ex)})
                    conn.close()
                except OSError:
                    pass

    def _listen(self) -> socket.socket:
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        srv.bind(self.socket_path)
        srv.listen(16)
        srv.settimeout(1.0)
        return srv

    def run(self) -> None:
        if self.device.type == "cuda":
            import torch

            from ..ops import _cuda

            # the kernels are built and loaded, and the card's context made,
            # before the first request
            _cuda.load_all()
            torch.empty(1, device=self.device)
        srv = self._listen()
        threading.Thread(target=self._serve_thread, args=(srv,), daemon=True).start()
        threading.Thread(target=self._job_thread, daemon=True).start()
        while not self._stop:
            time.sleep(0.5)
            with self.state_lock:
                key = self.pending.pop(0) if self.pending else None
                if key is not None:
                    self.warming = key
            if key is None:
                continue
            try:
                self._warm_one(self.entries[key])
                with self.state_lock:
                    self.warm.append(key)
            except Exception as ex:  # report, keep serving the warm entries
                _log(f"warm {key} FAILED: {ex!r}\n{traceback.format_exc()}")
                with self.state_lock:
                    self.failed[key] = repr(ex)
            finally:
                with self.state_lock:
                    self.warming = None
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass
        _log("stopped")


def _send(conn: socket.socket, obj: dict) -> None:
    conn.sendall((json.dumps(obj) + "\n").encode())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warm", default="delay_enc:16",
                    help="comma list of workload:k or batch:k:b, warmed in order")
    ap.add_argument("--socket", default=None, help="unix socket (default: the repo's .daemon.sock)")
    ap.add_argument("--srs-dir", required=True, help="SRS files, read or written")
    ap.add_argument("--key-dir", default=None, help="key cache (default: --srs-dir)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--selfcheck", default="auto", choices=("auto", "0", "1", "2"),
                    help="host-oracle level of every proof; auto: 1 for warmups, else 0")
    ap.add_argument("--msm", default="b4", choices=("b4", "b16"))
    ap.add_argument("--stub-warm-s", type=float, default=0.0,
                    help="seconds that a stub:k entry (k > 0) takes to warm")
    args = ap.parse_args(argv)
    from .client import default_socket_path

    Daemon(parse_warm(args.warm), args.socket or default_socket_path(), args.srs_dir,
           args.key_dir, args.device, args.msm,
           None if args.selfcheck == "auto" else int(args.selfcheck),
           args.stub_warm_s).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
