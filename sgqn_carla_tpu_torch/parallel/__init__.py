from sgqn_carla_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    MeshSpec,
    backend_for,
    default_devices,
    env_range,
    from_env,
    launch,
    put_env_batch,
    put_replicated,
)
