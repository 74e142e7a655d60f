"""Malicious-node attack switches (byzantine fault injection), PyTorch.

Counterpart of ``oversim_tpu/common/malicious.py``: the attacker flags
live in the engine (``SimState.malicious``, drawn per slot with
``probability``).  All attacks are off by default; the FindNode attacks
themselves (``attack_findnode``) are still to be ported with the
overlays' malicious options, which refuse to run until then.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MaliciousParams:
    """default.ini:529-536 + BaseOverlay.h:203-206."""

    probability: float = 0.0
    drop_find_node: bool = False
    is_sibling: bool = False
    invalid_nodes: bool = False

    @property
    def active(self) -> bool:
        return self.probability > 0.0
