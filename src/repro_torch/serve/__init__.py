"""repro_torch.serve: the serving layer.

* :mod:`repro_torch.serve.engine` -- continuous-batching LM serving with
  the Clutch threshold sampler (the ``minp_mask`` kernel).
* :mod:`repro_torch.serve.pud_service` -- the request/response front end
  over :class:`repro_torch.pud.PudSession`: batched PuD query/inference
  requests with per-request results and latency attribution (host
  Python; every request runs through the session's kernels).

Serving model
-------------
The PuD serving stack turns job latencies -- a machine job's modeled
makespan, a fused job's measured wall-clock on the card -- into
application-level serving metrics (p50/p99 latency, goodput under
offered load) on ONE simulated clock:

* :mod:`repro_torch.serve.arrivals` -- open-loop arrival generation:
  Poisson, bursty on/off, and replayable JSON-lines traces, each
  arrival a :class:`~repro_torch.serve.pud_service.PudRequest` with an
  absolute timestamp, a priority class, and a relative ``deadline_ns``
  SLO.
* :mod:`repro_torch.serve.admission` -- weighted per-class priority with
  a starvation bound, shedding overload with explicit 429-style
  ``PudResponse.error`` instead of silent drops.
* :mod:`repro_torch.serve.batcher` -- deadline-aware batch formation: a
  candidate batch is probe-executed on the card, members whose
  attributed completion blows their remaining budget split into a
  leaner batch that runs first, and the probe's results are discarded.
* :mod:`repro_torch.serve.loop` -- the event loop binding the above:
  ingest -> admit -> form -> execute -> scale; queueing delay eats
  deadline budget, service time feeds back into queueing, saturation
  emerges; each dispatched request is reported to the active pudlint
  collector (PL401) and each dispatch retires its resource's traces.
* :mod:`repro_torch.serve.autoscaler` -- rolling host-utilization bands
  trigger re-evaluation; a machine job's recorded streams re-schedule
  under every ``(host_lanes, hosts)`` candidate and the argmin config
  applies through the session hooks.

Submodules are imported explicitly (``engine`` pulls in the models; the
PuD serving stack does not).
"""
