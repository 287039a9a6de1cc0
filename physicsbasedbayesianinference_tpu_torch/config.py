"""Run configuration: one dataclass, JSON round-trip (port of the JAX
package's ``config.py``).

The fields and defaults are the JAX package's, so a JSON file written by
either package loads in the other, plus ``device``: where the command-line
driver (:mod:`.main`) puts every tensor. ``kernel`` takes ``auto | fused |
composed`` (``hmc.resolve_engine``); the JAX name ``"xla"`` is refused.
``sharded=True`` runs HMC with the diagonal metric over a walker group
(``parallel.sharded_run_hmc``), uncheckpointed and not in stream mode;
every other sharded run raises naming what is missing: the JAX package
sends those through GSPMD with ``kernel="xla"``, which the port does not
have.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

KERNELS = ("auto", "fused", "composed")


@dataclasses.dataclass
class RunConfig:
    """Everything needed to reproduce a sampling run."""

    # model: "builtin:<potential>" (ops.potentials.builtin_potentials),
    # "example:<model>" (models.examples.EXAMPLE_MODELS, with data_path);
    # "numpyro:<module>:<fn>" is the JAX package's only (NumPyro is JAX)
    model: str = "builtin:std_normal_2d"
    data_path: Optional[str] = None
    # non-centering for example: models: "" (off), "auto" (rewrite latent
    # loc-scale sites that depend on other latents), or a comma-separated
    # site list (models/core.reparam)
    reparam: str = ""

    sampler: str = "hmc"            # hmc | nuts | smc | pt | chees
    kernel: str = "auto"            # auto | fused | composed
    metric: str = "diag"            # diag | dense: hmc mass-matrix form
    num_walkers: int = 1024
    num_warmup: int = 500
    num_samples: int = 500
    num_steps: int = 16             # hmc leapfrog steps / smc mutation len
    max_depth: int = 8              # nuts
    init_step_size: float = 0.1
    target_accept: float = 0.8
    adapt_mass: bool = True
    temperature: float = 1.0        # physical T (k_B from constants)
    constants: str = "natural"      # natural | si
    seed: int = 0
    collect: str = "samples"        # samples | moments | none | stream
    thin: int = 1

    # smc extras
    smc_beta0: float = 0.0
    smc_max_stages: int = 50

    # parallel-tempering extras
    pt_replicas: int = 8
    pt_beta_min: float = 0.05

    # execution
    sharded: bool = False            # hmc over a walker group (torchrun)
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0        # 0 = only final
    output_path: Optional[str] = None  # .npz samples/summary dump
    log_every: int = 100
    device: str = "cuda"             # where every tensor of the run lives

    def __post_init__(self):
        self.check()

    def check(self) -> None:
        """Raise ``ValueError`` for a value the port does not run."""
        if self.kernel not in KERNELS:
            raise ValueError(f"bad kernel={self.kernel!r} (want "
                             f"{'|'.join(KERNELS)}; 'xla' is the JAX "
                             f"package's name for 'composed')")
        if not self.sharded:
            return
        missing = (
            f"sampler={self.sampler!r} (sharded runs take sampler='hmc')"
            if self.sampler != "hmc" else
            "metric='dense'" if self.metric == "dense" else
            "checkpoint_dir (per-rank checkpoint shards)"
            if self.checkpoint_dir else
            "collect='stream'" if self.collect == "stream" else None)
        if missing:
            raise ValueError(
                f"sharded=True with {missing} is not ported yet (the JAX "
                f"package runs it through GSPMD with kernel='xla'; "
                f"ROADMAP.md queue 1 item 11)")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "RunConfig":
        data = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(data) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**data)

    @classmethod
    def from_file(cls, path: str) -> "RunConfig":
        with open(path) as f:
            return cls.from_json(f.read())
