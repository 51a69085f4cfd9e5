"""Analytic scaling model of a multi-device query (counterpart of
hdk_tpu/parallel/ici_model.py, with no link figure of its own).

Per device, n devices:

  T_n = T_compute(1) / n              -- row-parallel compute
      + wire_bytes(n) / link_rate     -- collective payload over the links
      + n_collectives * alpha         -- fixed cost per collective

  efficiency(n) = T_1 / (n * T_n)

``wire_bytes(n)`` and the collective count come from
``utils/commlog.summarize`` of a capture taken at n shards.  The link
rate and the per-collective cost are the caller's: they describe the
machine, which this module does not assume.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..utils import commlog


@dataclass
class LinkModel:
    link_bytes_per_sec: float  # usable per-device link rate
    alpha_per_collective: float  # seconds per collective (launch, sync)

    def predict(self, compute_s_1dev: float, records: List[dict],
                n_devices: int) -> Dict:
        """Predicted efficiency of one query at ``n_devices`` from its
        single-device compute time and its capture at ``n_devices``."""
        s = commlog.summarize(records, n_devices)
        t_compute = compute_s_1dev / max(n_devices, 1)
        t_wire = s["wire_bytes_per_device"] / self.link_bytes_per_sec
        t_launch = s["n_collectives"] * self.alpha_per_collective
        t_n = t_compute + t_wire + t_launch
        eff = (compute_s_1dev / (n_devices * t_n)) if t_n > 0 else 1.0
        return {
            "n_devices": n_devices,
            "t_compute_s": t_compute,
            "t_wire_s": t_wire,
            "t_launch_s": t_launch,
            "t_total_s": t_n,
            "predicted_efficiency": round(min(eff, 1.0), 4),
            **s,
        }
