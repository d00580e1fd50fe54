from .adapters import (
    LiberoPolicyAdapter,
    SimplerEnvPolicyAdapter,
    euler_to_axis_angle,
    run_simpler_env,
)

__all__ = [
    "LiberoPolicyAdapter",
    "SimplerEnvPolicyAdapter",
    "euler_to_axis_angle",
    "run_simpler_env",
]
