"""CLI: ``python -m repro_torch.analysis``: both fronts, exit 1 on any
finding.  A CPU tool: the semantic front runs its entry points on meta and
CPU tensors over a fake process group."""
from __future__ import annotations

import argparse


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's lint (L1-L4) and its collective, ring and "
                    "kernel-budget checks (S1-S3)")
    ap.add_argument("--lint-only", action="store_true",
                    help="skip the semantic front")
    ap.add_argument("--root", default=None,
                    help="repo root to lint (default: this checkout)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import RULES, run_repo_analysis
    findings = run_repo_analysis(root=args.root, semantic=not args.lint_only)
    for f in findings:
        print(f)
    active = [r for r in RULES if not args.lint_only or r.startswith("L")]
    if findings:
        print(f"repro_torch.analysis: {len(findings)} finding(s) "
              f"({', '.join(sorted({f.rule for f in findings}))})")
        return 1
    print(f"repro_torch.analysis: clean ({', '.join(active)} active)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
