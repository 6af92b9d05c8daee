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

The gateway, its engines and the registry loads run on ``device="cuda"``
unless the caller passes ``device="cpu"``. Worker processes
(``WorkerPool``) and the serving-data flywheel are not ported yet; the LM
decode server is not either.
"""
from repro_torch.serve.gateway import TopoGateway
from repro_torch.serve.registry import (ModelRecord, ModelRegistry,
                                        ModelResolver, NoModelError)
from repro_torch.serve.topo_service import TopoServingEngine
from repro_torch.serve.types import (EngineClosed, EngineState, FleetEvent,
                                     GatewayOverloaded, OverloadPolicy,
                                     QueueFull, RequestShed, TagStats,
                                     TopoFuture, TopoRequest, WorkerLost,
                                     pool_stats, throughput_view)

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
]
