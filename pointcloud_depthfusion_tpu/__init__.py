"""pointcloud_depthfusion_tpu — RGB-D depth fusion in JAX.

Top-level convenience exports (lazy, PEP 562): importing the package is
free — submodules load on first attribute access, and nothing here touches
the JAX backend, so importing never initializes (or waits on) an
accelerator.

    from pointcloud_depthfusion_tpu import FusionPipeline, Frameset
"""

from __future__ import annotations

__version__ = "0.1.0"  # keep in sync with pyproject.toml

_EXPORTS = {
    # core
    "Intrinsics": "pointcloud_depthfusion_tpu.core.camera",
    "Extrinsics": "pointcloud_depthfusion_tpu.core.camera",
    "CameraInfo": "pointcloud_depthfusion_tpu.core.camera",
    "Distortion": "pointcloud_depthfusion_tpu.core.camera",
    "fused_virtual_intrinsics": "pointcloud_depthfusion_tpu.core.camera",
    "Frameset": "pointcloud_depthfusion_tpu.core.frameset",
    "HostFrameset": "pointcloud_depthfusion_tpu.core.frameset",
    "PointCloud": "pointcloud_depthfusion_tpu.core.pointcloud",
    # fusion
    "FusionConfig": "pointcloud_depthfusion_tpu.fusion.pipeline",
    "FusionPipeline": "pointcloud_depthfusion_tpu.fusion.pipeline",
    "fuse": "pointcloud_depthfusion_tpu.fusion.pipeline",
    # registration
    "GICPConfig": "pointcloud_depthfusion_tpu.registration.gicp",
    "gicp_register": "pointcloud_depthfusion_tpu.registration.gicp",
    "RegistrationPipeline": "pointcloud_depthfusion_tpu.registration.pipeline",
    "RegistrationSettings": "pointcloud_depthfusion_tpu.registration.pipeline",
    # rigs / parallel
    "rig_fuse": "pointcloud_depthfusion_tpu.parallel.mesh",
    "rig_fuse_sharded": "pointcloud_depthfusion_tpu.parallel.mesh",
    "batched_rig_fuse": "pointcloud_depthfusion_tpu.parallel.mesh",
    "make_camera_mesh": "pointcloud_depthfusion_tpu.parallel.mesh",
    # io
    "DeviceFeeder": "pointcloud_depthfusion_tpu.io.feeder",
    "RigFeeder": "pointcloud_depthfusion_tpu.io.feeder",
    "SyntheticSource": "pointcloud_depthfusion_tpu.io.feeder",
    "RecordedSource": "pointcloud_depthfusion_tpu.io.recorded",
    "NetworkSource": "pointcloud_depthfusion_tpu.io.network",
    "SyntheticScene": "pointcloud_depthfusion_tpu.io.synthetic",
    # nodes
    "CameraNode": "pointcloud_depthfusion_tpu.nodes.camera_node",
    "FusionNodeApp": "pointcloud_depthfusion_tpu.nodes.fusion_node",
    "RegistrationNodeApp": "pointcloud_depthfusion_tpu.nodes.registration_node",
    "RigFusionNodeApp": "pointcloud_depthfusion_tpu.nodes.rig_node",
    "ImageNode": "pointcloud_depthfusion_tpu.nodes.image_node",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    return getattr(importlib.import_module(mod), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
