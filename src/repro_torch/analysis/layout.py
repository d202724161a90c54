"""Kernel cap ownership (rule PALLAS002).

Port of the cap half of ``repro/analysis/layout.py``.  The kernels' caps
must agree between the Python that dispatches to a kernel and the CUDA
source that compiles it: the register buckets and the warp-sort and
shared-memory worker caps of the selection kernels, the Gram kernel's tile,
the paged cache's block size and the collectives' staging size.  PALLAS002
enforces single-sourcing: each cap is assigned at module level in exactly
one owning module and imported everywhere else, so that no second copy can
drift.  The values themselves are held against the CUDA sources by
PALLAS003 (``repro_torch.analysis.contracts``).

The reference's other rule here, PALLAS001, has no counterpart: no Python
of the port sets a block shape (``findings.py`` says why).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List

from repro_torch.analysis.findings import Finding

# Cap -> path suffix of the one module allowed to assign it.
CAP_OWNERS: Dict[str, str] = {
    "REGISTER_BUCKETS": "src/repro_torch/kernels/build.py",
    "WARP_SORT_MAX_M": "src/repro_torch/kernels/build.py",
    "MAX_M": "src/repro_torch/kernels/build.py",
    "GRAM_TILE": "src/repro_torch/kernels/build.py",
    "PAIRWISE_MAX_M": "src/repro_torch/core/selection.py",
    "BLOCK_TOKENS": "src/repro_torch/serve/cache.py",
    "STAGE_BYTES": "src/repro_torch/dist/collectives.py",
}


def analyze(path: str, tree: ast.Module) -> List[Finding]:
    findings: List[Finding] = []
    norm = os.path.abspath(path).replace("\\", "/")
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        for t in targets:
            if not isinstance(t, ast.Name) or t.id not in CAP_OWNERS:
                continue
            owner = CAP_OWNERS[t.id]
            if not norm.endswith("/" + owner):
                findings.append(Finding(
                    rule="PALLAS002", path=path, line=node.lineno,
                    message=f"kernel cap {t.id} is owned by {owner}; "
                            "assigning it here lets the caps silently "
                            "diverge",
                    hint=f"import {t.id} from its owning module instead"))
    return findings
