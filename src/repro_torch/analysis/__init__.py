"""repro_torch.analysis: the port's conventions, machine-checked.

The port's counterpart of ``repro.analysis``, over the port's own sources
(``src/repro_torch``, ``tests/test_torch_*.py`` and their ``torch_*.py``
helpers, ``chip_smoke.py``).  Two fronts:

* **AST lint** (:mod:`repro_torch.analysis.lint`), stdlib ``ast`` only:

  =====  ==================================================================
  L1     collectives only through ``parallel.comm``: no
         ``torch.distributed`` collective outside
         ``src/repro_torch/parallel/comm.py`` and the probe it names
         (``testing/nccl_probe.py``)
  L2     import hygiene: no import-time ``os.environ`` mutation in a test
         module of the port outside ``tests/conftest.py``
  L3     no ``BENCH_*.json`` write (the port's benchmark brings its writer)
  L4     no wall-clock timing outside ``repro_torch.testing.timing``
  =====  ==================================================================

* **semantic checks** (:mod:`repro_torch.analysis.record_check`, the twin
  of the reference's ``jaxpr_check``, and
  :mod:`repro_torch.analysis.schedule_check`): the port has no jaxpr, so
  its entry points run once on rank 0 of a mesh over torch's ``fake``
  process group (``launch.dryrun.fake_world``) and the collectives
  ``parallel.comm`` records are checked:

  =====  ==================================================================
  S1     pricing coverage: every recorded collective's group resolves
         through ``roofline.analysis.group_level_extents`` on the declared
         topology without the flat fallback
  S2     ring-schedule safety: every shift ``comm`` builds is a full-ring
         uniform circular shift of its group
  S3     the kernel budget: every launch plan at the main path's shapes
         (``testing.kernel_checks``' cases) fits ``kernels.hopper``'s limits
  =====  ==================================================================

Suppression: append ``# repro: noqa(RULE)`` (comma-separated rules) to the
offending line, with a comment saying why the rule does not apply there.

    PYTHONPATH=src python -m repro_torch.analysis [--lint-only]

exits 1 on any finding.  It is a CPU tool: it runs on no card.
"""
from __future__ import annotations

import dataclasses
import pathlib

#: rule id -> one-line description
RULES = {
    "L1": "collectives only through repro_torch.parallel.comm",
    "L2": "import hygiene: no import-time os.environ mutation in the port's "
          "test modules outside tests/conftest.py",
    "L3": "no BENCH_*.json writes",
    "L4": "wall-clock timing only through repro_torch.testing.timing",
    "S1": "collective pricing coverage: groups resolve on the declared "
          "Topology without the flat fallback",
    "S2": "ring-schedule safety: full-ring uniform-shift permutes",
    "S3": "kernel budget: launch plans fit the H100's per-block limits",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violation: rule id, location, what, and how to fix it."""
    rule: str                    # "L1".."L4" / "S1".."S3"
    path: str                    # repo-relative file, or entry-point label
    line: int                    # 1-based source line; 0 for traced entries
    message: str
    hint: str = ""

    def __str__(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        s = f"{loc}: {self.rule}: {self.message}"
        if self.hint:
            s += f"  [fix: {self.hint}]"
        return s


def repo_root() -> pathlib.Path:
    """The repo root this package lives in (src/repro_torch/analysis/..)."""
    return pathlib.Path(__file__).resolve().parents[3]


def run_repo_analysis(root: pathlib.Path | None = None,
                      semantic: bool = True) -> list[Finding]:
    """Both fronts over the repo; ``semantic=False`` for the lint alone.
    The semantic front sets up (and tears down) a fake process group, so
    it needs a process without one."""
    from repro_torch.analysis import lint
    root = pathlib.Path(root) if root is not None else repo_root()
    findings = lint.lint_repo(root)
    if semantic:
        from repro_torch.analysis import record_check
        findings += record_check.semantic_findings()
    return findings
