"""REPxxx rule registry (one module per invariant family) — the reference's
ten codes, recognising PyTorch's names beside jax's."""
from repro_torch.analysis.rules.hotloop import REP006
from repro_torch.analysis.rules.jaxsafe import REP004, REP005, REP007
from repro_torch.analysis.rules.rng import REP001, REP002
from repro_torch.analysis.rules.threads import REP003, REP008
from repro_torch.analysis.rules.wirekind import REP009, REP010

ALL_RULES = [REP001(), REP002(), REP003(), REP004(), REP005(), REP006(),
             REP007(), REP008(), REP009(), REP010()]

__all__ = ["ALL_RULES", "REP001", "REP002", "REP003", "REP004", "REP005",
           "REP006", "REP007", "REP008", "REP009", "REP010"]
