"""Frozen vocabularies for metric and span names, the same sets as
``repro.obs.names``.

The observability namespace is closed: the registry rejects unregistered
metric names and an armed span rejects an unregistered span name. A
typo'd metric silently forks the series CI and the report CLI read, so a
new instrument means a new member HERE first, and in the reference's.
Some names are the reference's alone (``autotune.*``, ``runtime.*``,
``health.repromote``): the port records none of them yet.

Naming scheme: ``<layer>.<what>[_<unit>]`` — layers are ``dispatch``
(the ops entry points), ``autotune``, ``health``, ``serve``, ``train``;
durations carry an ``_s`` suffix, monotonically increasing totals a
``_total`` suffix. Label keys are reused from the existing
vocabularies: ``site`` (dispatch site), ``key`` (autotune shape
key), ``rung`` (``cuda`` or ``plain`` in the port), ``reason``/``action``
(health.Reason), ``arch`` (model config name).
"""
from __future__ import annotations

#: counter / gauge / histogram names the Registry accepts
METRICS = frozenset({
    # kernel dispatch (the ops entry points) — per autotune shape key
    "dispatch.calls",
    "dispatch.seconds_total",
    "dispatch.est_hbm_bytes_total",
    "dispatch.log_calls",          # named DispatchLog mirrors (key hits)
    # autotune searches
    "autotune.searches",
    "autotune.candidates",
    "autotune.pruned",
    "autotune.cost_skipped",       # ranked early-exit leftovers, untimed
    # health registry mirror (site/reason/action labels)
    "health.events",
    "health.repromote",            # circuit-breaker probation passed
    # the reference's runtime fault domain: in-compiled-call failures
    "runtime.demote",              # guest trap / sentinel → rung demoted
    "runtime.retrace_ms",          # cumulative re-jit cost after demotion
    # serving
    "serve.requests",
    "serve.retries",
    "serve.deadline_exceeded",
    "serve.stragglers",
    "serve.tokens_generated",
    "serve.prefill_s",
    "serve.ttft_s",
    "serve.decode_step_s",
    "serve.request_s",
    "serve.slots_total",
    "serve.slots_recyclable",
    "serve.slot_occupancy",
    "serve.kv_cache_bytes",
    "serve.quarantined",           # poisoned slots eos-masked + recycled
    "serve.shed",                  # requests rejected at admission
    "serve.journal_replayed",      # in-flight requests replayed on restart
    # training
    "train.steps",
    "train.tokens",
    "train.step_s",
    "train.tokens_per_s",
    "train.ckpt_save_s",
    "train.resumes",
    "train.loss",
    # string-valued facts tables (Registry.facts)
    "run.info",
    "serve.run",
    "dispatch.attn_decode",
    "dispatch.quant_fallback",
})

#: trace span / instant names (obs.span / obs.traced / obs.instant)
SPANS = frozenset({
    "kernel.dispatch",
    "autotune.search",
    "autotune.candidate",
    "serve.generate",
    "serve.prefill",
    "serve.decode_step",
    "serve.quantize",
    "train.step",
    "train.ckpt_save",
    "train.resume",
    "health.event",
})
