"""Several ranks: the mesh and its collectives (:mod:`.comm`, the only
module of the port that calls ``torch.distributed``), the int8 ring
all-reduce (:mod:`.compression`), a launcher of ranks on one host
(:mod:`.ranks`), and the step loop's fault handling
(``repro.distributed.fault``)."""

from repro_torch.distributed.fault import (  # noqa: F401
    StepGuard, StragglerPolicy, UnreplayableStepError)
