"""The control of `correct`, read on the card at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3
                                 [--seconds 10]

For each seed, one run of run.py in this process (its set-up, a window
of --seconds, its sample), with the sample decoded twice: by the
reference, and by the reference with its inverse transform truncating
instead of rounding (reference/decoder.py IDCT_ROUND = 0), a
reconstruction one bit coarser than the standard's: the nearest lower
precision that a later change could be tempted to, which a conforming
encoder's reconstruction has to fail. The benchmark's own runs never do
this. Prints, for each seed, both readings of every number compared,
and the lower and upper readings (PERF.md section 2 sets the limits from
them).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    from portbench import check, run
    from portbench.reference import decoder

    compare, readings = check.compare, []

    def both(*a, **kw):
        sound = compare(*a, **kw)
        decoder.IDCT_ROUND = 0
        try:
            ctl = compare(*a, **kw)
        finally:
            decoder.IDCT_ROUND = 32
        readings.append({n: (sound["numbers"][n]["value"],
                             ctl["numbers"][n]["value"])
                         for n in sound["numbers"]})
        readings[-1]["control_correct"] = ctl["correct"]
        return sound

    check.compare = both
    rcs = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        rcs.append(run.main(["--workload", args.workload, "--seed",
                             str(seed), "--seconds", str(args.seconds),
                             "--trace", "0"]))
        if readings:
            readings[-1]["seed"] = seed
    names = [n for n in readings[0] if n not in ("seed", "control_correct")] \
        if readings else []
    summary = {n: {"lower": max(r[n][0] for r in readings),
                   "upper": min(r[n][1] for r in readings)} for n in names}
    print(json.dumps({"workload": args.workload, "rcs": rcs,
                      "readings": readings, "summary": summary}),
          flush=True)
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main())
