"""Topology-optimization serving on the port: the counterpart of
``repro.serve``.

One front door over per-mesh engines, models from a registry shared with
the JAX package::

    from repro_torch.common import init_params
    from repro_torch.serve import ModelRegistry, TopoGateway, TopoRequest

    reg = ModelRegistry("runs/registry")      # either package's registry
    reg.register(init_params(cfg, seed=0, dtype="float32"), cfg, 50.0,
                 tag="v1")
    gw = TopoGateway.from_registry(reg, "v1", slots=4)   # on the card
    fut = gw.submit(TopoRequest(uid=0, problem=prob, n_iter=60))
    req = fut.result()            # req.model_tag says which version served
    gw.canary("v2", fraction=0.1, mesh=(30, 20))
    gw.promote(mesh=(30, 20))     # or rollback(); auto-rollback on regression
    gw.shutdown()

Multi-process engine workers::

    from repro_torch.serve import TopoGateway, TopoRequest, WorkerLost

    gw = TopoGateway.from_registry(reg, "prod", slots=4,
                                   workers=3)   # 3 engine processes
    fut = gw.submit(TopoRequest(uid=0, problem=prob, n_iter=60))
    req = fut.result()            # req.worker_id says which process
    try:
        other = gw.submit(...).result()
    except WorkerLost as e:       # a worker died mid-tick: typed, with
        retry(e.worker_id)        # the dead worker's id; never silent

``workers=N`` moves the engine pool into N spawned worker processes
(serve/workers.py), one interpreter and one CUDA context each: tick
loops no longer share one GIL, and a tick loop's
``torch.cuda.synchronize`` waits on its own process's work only. The
gateway keeps the admission queue, routing, canaries and leases; workers
lease mesh buckets, build engines locally from the shared on-disk
registry (or from params pickled by value), and speak a length-prefixed
pickle RPC over pipes. A request served through a worker is
BITWISE-equal to the same request on an in-process engine. Robustness:
heartbeats + deadline-aware RPC timeouts; on a worker crash, admitted
in-flight requests fail with typed ``WorkerLost`` while never-admitted
ones requeue in EDF order onto a respawned worker (every future
resolves); ``worker-*`` FleetEvents narrate spawn/lost/reassign/requeue,
and completions carry ``worker_id``. Each worker counts its own kernel
launches (``WorkerPool.launch_counts``).

The serving-data flywheel: train a version, serve it with a harvest
sink, and let a controller fine-tune, canary and promote a bucket
specialist from the traffic the surrogate failed on::

    from repro_torch.fea import train_cronet
    from repro_torch.serve import FlywheelController, HarvestLog

    train_cronet.train_and_register(cfg, reg, tag="base", steps=400)
    log = HarvestLog(accept_below=0.8, spool_dir="runs/harvest")
    gw = TopoGateway.from_registry(reg, "base", slots=4, harvest=log)
    fly = FlywheelController(gw, log, trigger_below=0.5)
    fly.tick()          # or fly.start(): trigger -> harvest -> train ->
    #                     canary -> promote / rollback, as flywheel-*
    #                     FleetEvents in gw.events

The gateway, its engines (in a worker too), the registry loads, dataset
generation and training run on ``device="cuda"`` unless the caller
passes ``device="cpu"``; the flywheel trains on its gateway's device.

The LM-decode serving half (``server``, ``decode``), as in the
reference, is not re-exported here: import those modules directly.
"""
from repro_torch.serve.flywheel import (FlywheelController, FlywheelCycle,
                                        FlywheelState, HarvestLog,
                                        RegistryRetention)
from repro_torch.serve.gateway import TopoGateway
from repro_torch.serve.registry import (ModelRecord, ModelRegistry,
                                        ModelResolver, NoModelError)
from repro_torch.serve.topo_service import TopoServingEngine
from repro_torch.serve.types import (EngineClosed, EngineState, FleetEvent,
                                     GatewayOverloaded, OverloadPolicy,
                                     QueueFull, RequestShed, TagStats,
                                     TopoFuture, TopoRequest, WorkerLost,
                                     pool_stats, throughput_view)
from repro_torch.serve.workers import WorkerPool

__all__ = [
    "TopoGateway",
    "TopoServingEngine",
    "ModelRegistry",
    "ModelRecord",
    "ModelResolver",
    "NoModelError",
    "TopoRequest",
    "TopoFuture",
    "OverloadPolicy",
    "GatewayOverloaded",
    "QueueFull",
    "RequestShed",
    "EngineState",
    "EngineClosed",
    "FleetEvent",
    "TagStats",
    "WorkerLost",
    "pool_stats",
    "throughput_view",
    "WorkerPool",
    "HarvestLog",
    "FlywheelController",
    "FlywheelState",
    "FlywheelCycle",
    "RegistryRetention",
]
