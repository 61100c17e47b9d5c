"""What a traced run of the joint cell reads besides ``probes.py``.

- The two kernel entries that only joint compression reaches,
  ``repro_torch.kernels.ops.warp`` and ``ops.histogram``, wrapped as
  ``probes.py`` wraps the codec's (a ``vss.kernel.<entry>`` range, so
  ``devtrace`` times the device work each call launched, and the bytes of
  the call's tensors, ``rooflines.io_bytes``).  The joint traffic adds
  them to the run's probes for its window; the run's ``uninstall``
  restores them with the others.
- Idle shares under the joint pass's stages (``span_idle``), read only
  from a program whose joint pass names them: one that counts its pairs
  (``vss_joint_pairs_total``, which came with the ``vss.joint.*``
  spans).  An older program gives no reading, not a 0.0.
"""
from __future__ import annotations

from typing import Optional, Tuple

from vssbench import probes, readers, span_idle

ENTRIES = ("warp", "histogram")
MATCH = ("vss.joint.correspond", "vss.joint.estimate")
VERIFY = ("vss.joint.verify",)


def install(run) -> None:
    from repro_torch.kernels import ops

    p = run.probes
    for name in ENTRIES:
        fn = getattr(ops, name)
        p.kernel_calls[name] = []
        p.saved.append((ops, name, fn))
        setattr(ops, name, probes._wrap_kernel(p, name, fn))


def roofline_pct(run, entry: str) -> Optional[float]:
    if run.probes is None or entry not in run.probes.kernel_calls:
        return None
    return readers.roofline_pct(run, entry)


def idle_pct(run, patterns: Tuple[str, ...]) -> Optional[float]:
    if "vss_joint_pairs_total.joint" not in run.counters:
        return None
    return span_idle.idle_pct(run, patterns)


def gop_share_pct(run) -> Optional[float]:
    """GOPs the joint pass stored jointly over the GOPs the window wrote,
    %."""
    joint = run.counters.get("vss_joint_gops_total")
    written = sum(1 for r in run.requests if r.kind == "append" and r.ok)
    if joint is None or not written:
        return None
    return 100.0 * joint / written
