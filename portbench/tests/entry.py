"""The rehearsal entry of portbench/run.py for the tests: runs the
harness at 64x48 (portbench/tests/rehearsal), on the CPU unless --device
is given, with one fault planted underneath its timed path when asked.

    python3 portbench/tests/entry.py <fault> <run.py arguments...>

Faults: none; stale_recon (the encoder hands back the reconstruction of
the frame before: a step that returns its state unchanged); altered_nal
(a byte of each P slice flipped where it is produced); control (the
reference's inverse transform truncates: the benchmark's control)."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

REHEARSAL = ["--manifest", os.path.join(HERE, "rehearsal", "bench.json"),
             "--data", os.path.join(HERE, "rehearsal")]


def plant(fault):
    from x264_tpu_torch.encoder import encoder as E
    if fault == "stale_recon":
        orig = E.Encoder._finalize_job
        last = {}

        def stale(self, job):
            nals, out = orig(self, job)
            prev = last.get("recon")
            last["recon"] = out.recon
            if prev is not None:
                out.recon = prev
            return nals, out
        E.Encoder._finalize_job = stale
    elif fault == "altered_nal":
        orig = E.Encoder._finalize_job

        def altered(self, job):
            nals, out = orig(self, job)
            for n in nals:
                if n.payload[0] & 0x1F == 1 and len(n.payload) > 8:
                    b = bytearray(n.payload)
                    b[len(b) // 2] ^= 0x10
                    n.payload = bytes(b)
            return nals, out
        E.Encoder._finalize_job = altered
    elif fault == "control":
        from portbench.reference import decoder
        decoder.IDCT_ROUND = 0
    elif fault != "none":
        raise SystemExit(f"unknown fault {fault}")


if __name__ == "__main__":
    plant(sys.argv[1])
    from portbench import run
    argv = sys.argv[2:] + REHEARSAL
    if "--device" not in argv:
        argv += ["--device", "cpu"]
    sys.exit(run.main(argv))
