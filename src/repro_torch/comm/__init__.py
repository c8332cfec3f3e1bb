"""Wire format, codecs, transports and network simulation (port of ``repro.comm``).

- ``wire``      typed messages for the three payload kinds + exact byte layout
- ``codecs``    float casts, stochastic int8/int4 quantization (K10 in the
                batched engine), top-k sparsification and the O(1) seed-replay
                codec
- ``transport`` identity (analytic byte accounting) vs wire (real
                serialize/deserialize) transports + the CommLog record
- ``netsim``    Table-III-generalizing, trace-replayable network scenarios
- ``autocodec`` the cheapest codec meeting an accuracy budget, from the
                measured ``BENCH_comm.json`` curves
"""
from repro_torch.comm.autocodec import codec_table, pick_codec
from repro_torch.comm.autocodec import resolve as resolve_auto_codec
from repro_torch.comm.codecs import Codec, codec_names, get_codec, register_replay_generator
from repro_torch.comm.netsim import (
    BernoulliScenario,
    LinkModel,
    LinkScenario,
    Scenario,
    TableIIIScenario,
    TraceScenario,
    load_trace,
    record_trace,
    save_trace,
    table3_trace,
)
from repro_torch.comm.transport import (
    CommLog,
    IdentityTransport,
    Transport,
    WireTransport,
    build_transport,
    resolve_codecs,
)
from repro_torch.comm.wire import (
    Message,
    classifier_message,
    deserialize,
    moments_message,
    serialize,
    serialized_size,
    w_rf_message,
)

__all__ = [
    "BernoulliScenario", "Codec", "CommLog", "IdentityTransport", "LinkModel", "LinkScenario",
    "Message", "Scenario", "TableIIIScenario", "TraceScenario", "Transport", "WireTransport",
    "build_transport", "classifier_message", "codec_names", "codec_table", "deserialize",
    "get_codec", "load_trace", "moments_message", "pick_codec", "record_trace",
    "register_replay_generator", "resolve_auto_codec", "resolve_codecs", "save_trace",
    "serialize", "serialized_size", "table3_trace", "w_rf_message",
]
