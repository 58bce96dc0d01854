from polympc_torch.models.kite import kite_dynamics, kite_output, kite_path
from polympc_torch.models.race_car import (
    CarParams, pacejka_lateral_force, lateral_forces, car_body_accels,
    car_dynamics_cartesian, car_dynamics_curvilinear,
    car_dynamics_rate_augmented, race_car_ocp, make_wave_track,
)

__all__ = ["kite_dynamics", "kite_output", "kite_path",
           "CarParams", "pacejka_lateral_force", "lateral_forces",
           "car_body_accels", "car_dynamics_cartesian",
           "car_dynamics_curvilinear", "car_dynamics_rate_augmented",
           "race_car_ocp", "make_wave_track"]
