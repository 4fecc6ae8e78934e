"""Static analysis of the port: the plan contract verifier and the repo
lints (``dfft-torch-verify``) — the JAX package's ``analysis/``.

The JAX package lowers and compiles every rendering x direction x wire x
guard combo (never executing it) and reads XLA's output: ``hloscan``
counts collectives in the compiled HLO text, ``jaxprlint`` walks the
jaxpr. Eager PyTorch has neither. **The port reads the op trace of one
execution instead**: it runs the plan direction once, at the verifier's
small gate size, under a ``TorchDispatchMode`` that records every
dispatched op in order — name, argument shapes and dtypes, no values
(``opscan.record``). The contracts, the graph checks and the lints then
read that trace. Three details decide the rules:

* **Payloads cross as bytes.** Every exchange sends a ``uint8`` view
  (``parallel/transpose._bytes``), so the payload byte count is the c10d
  op's ``nbytes``, and "the native wire is bf16-free" becomes "no
  recorded op touches a ``bfloat16`` tensor": the collective's dtype no
  longer says it.
* **Kernels are invisible to the mode.** A ctypes launch
  (``ops/hopper_fft._launch``) is not a dispatched op, so the recorder
  also appends each launch as an op, by entry point and shapes, through
  ``hopper_fft.LAUNCH_HOOKS`` (empty, so free, when no recorder runs).
* **Gloo over CUDA stages through the host.** The census counts the c10d
  ops, not the staging copies around them.

A verification therefore executes the plan once per combo (at 20 x 16 x
16), where the JAX package only compiles it; on P ranks every rank runs
and records, and the ranks' censuses must agree.

=======================  ===========================  =====================
JAX module               port module                  reads
=======================  ===========================  =====================
``hloscan.py``           ``opscan.py``                the recorded op trace
                                                      (census, payload,
                                                      bf16, fingerprints)
``contracts.py``         ``contracts.py``             the rendering algebra
                                                      re-derived from the
                                                      port's calls
``jaxprlint.py``         ``oplint.py``                the op trace's
                                                      ``_to_copy`` ops,
                                                      c10d ops and guard
                                                      frames
``plangraph.py``         ``plangraph.py``             declared graphs; the
                                                      trace in place of
                                                      the jaxpr
``schedverify.py``       ``schedverify.py``           pure Python (the
                                                      port's
                                                      ``ring_schedule``)
``srclint.py``           ``srclint.py``               the port's source
                                                      (per-execution
                                                      bodies, lock helper)
``verify.py``            ``verify.py``                ``dfft-torch-verify``
=======================  ===========================  =====================
"""

from . import (  # noqa: F401
    contracts,
    opscan,
    oplint,
    plangraph,
    schedverify,
    srclint,
)
from .contracts import (  # noqa: F401
    Contract,
    ContractViolation,
    check_contract,
    contract_for,
    verify_plan,
)
from .opscan import (  # noqa: F401
    collective_census,
    contains_bf16,
    op_graph_fingerprint,
    plan_fingerprint,
    record,
    record_plan,
)
from .plangraph import (  # noqa: F401
    PlanGraph,
    StageEdge,
    StageNode,
    check_graph,
    graph_for,
    verify_graph,
)
from .schedverify import (  # noqa: F401
    check_schedule,
    revolving_schedule,
)
