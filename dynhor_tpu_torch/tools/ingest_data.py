"""Validate a custom sequence directory against the data convention.

Twin of ``tools/ingest_data.py``: the CLI over ``io/ingest.validate_dataroot``
(channel semantics, dtype and range, sizes, frame-id alignment across rgb/,
sam_seg/, monocular_normal/ and correspondence_infos/), with the same
print lines and exit codes: 1 on any error, else 0.

    python -m dynhor_tpu_torch.tools.ingest_data <dataroot> [--max-frames N]
"""
from __future__ import annotations

import argparse
import sys

from ..io.ingest import validate_dataroot


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataroot", help="sequence directory (contains rgb/ ...)")
    ap.add_argument(
        "--max-frames", type=int, default=None,
        help="only decode the first N frames (default: all)",
    )
    args = ap.parse_args(argv)
    findings = validate_dataroot(args.dataroot, max_frames=args.max_frames)
    n_err = sum(1 for f in findings if f.level == "error")
    n_warn = sum(1 for f in findings if f.level == "warning")
    for f in findings:
        print(str(f))
    print(
        f"{args.dataroot}: {n_err} error(s), {n_warn} warning(s)"
        + ("" if n_err else " — OK to ingest")
    )
    return 1 if n_err else 0


if __name__ == "__main__":
    sys.exit(main())
