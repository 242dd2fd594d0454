"""Online serving: compiled pipelines as a long-lived service (the port of
``src/repro/serve``).

    from repro_torch.serve import PipelineServer, ServeConfig
    cfg = ServeConfig.default(max_wait_ms=4.0).with_deadlines(250.0)
    server = PipelineServer(Retrieve("BM25") % 10, backend, cfg)
    server.warmup(Q_sample)
    result = server.submit_wait(q_row)
    print(server.stats())

``repro_torch.serve.batching`` (the LM decode pool) is imported by the
server itself.
"""
from repro_torch.serve.cache import StageResultCache, query_digest  # noqa: F401
from repro_torch.serve.config import ServeConfig  # noqa: F401
from repro_torch.serve.request import (DeadlineUnmeetable,  # noqa: F401
                                       RequestTimeout, RequestTrace,
                                       ServeRequest, ServerOverloaded)
from repro_torch.serve.scheduler import Batch, MicroBatchScheduler  # noqa: F401
from repro_torch.serve.server import (MultiPipelineServer,  # noqa: F401
                                      PipelineServer)
from repro_torch.serve.trace import TraceLog, latency_summary  # noqa: F401
