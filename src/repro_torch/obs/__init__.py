"""Round telemetry for the chunked engine (counterpart of repro/obs).

Three layers, all fed from the ONE host read per engine chunk — attaching
telemetry never adds a device→host transfer to the chunk
(tests/test_torch_engine.py counts the reads):

  * ``sinks``     — MetricsSink protocol + in-memory / stdout / JSONL file
                    sinks with the reference's versioned row schema, drained
                    at chunk boundaries by ``core/engine.run_rounds`` and per
                    round by the loop in ``core/server.run_federated``; plus
                    the OFF-by-default ``LiveTap``, called per slot inside
                    a chunk (eagerly on the CPU, from a host node of the
                    chunk's CUDA graph on the card), whose rows equal the
                    chunk's readout bit for bit.
  * ``profiling`` — on-demand ``torch.profiler`` windows around chunks
                    ("trace rounds T..T+N", armed by config or a trigger
                    file), exported as Chrome traces that carry the
                    ``record_function`` round phases of the eager round.
  * ``alarms``    — declarative health rules over the streamed rows
                    (non-finite loss, AA Gram conditioning, column-filtering
                    collapse, rel-error plateau) that log structured warnings
                    and can request an early stop at the next chunk boundary.
"""
from repro_torch.obs.alarms import (  # noqa: F401
    DEFAULT_RULES,
    AlarmMonitor,
    AlarmRule,
)
from repro_torch.obs.profiling import (  # noqa: F401
    TraceCapture,
    TraceConfig,
    find_trace_files,
    trace_contains,
)
from repro_torch.obs.sinks import (  # noqa: F401
    ROW_FIELDS,
    SCHEMA_VERSION,
    JsonlSink,
    LiveTap,
    MemorySink,
    MetricsSink,
    StdoutSink,
    build_round_row,
    make_sink,
)
