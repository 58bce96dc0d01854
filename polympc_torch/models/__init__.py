from polympc_torch.models.kite import (
    kite_dynamics, kite_output, kite_path, kite_ocp,
)
from polympc_torch.models.mobile_robot import robot_ocp, parking_ocp
from polympc_torch.models.cstr import (
    cstr_ocp, CSTR_XS, CSTR_US, CSTR_X0, CSTR_ULB, CSTR_UUB,
)
from polympc_torch.models.race_car import (
    CarParams, pacejka_lateral_force, lateral_forces, car_body_accels,
    car_dynamics_cartesian, car_dynamics_curvilinear,
    car_dynamics_rate_augmented, race_car_ocp, make_wave_track,
)

__all__ = ["kite_dynamics", "kite_output", "kite_path", "kite_ocp",
           "robot_ocp", "parking_ocp",
           "cstr_ocp", "CSTR_XS", "CSTR_US", "CSTR_X0",
           "CSTR_ULB", "CSTR_UUB",
           "CarParams", "pacejka_lateral_force", "lateral_forces",
           "car_body_accels", "car_dynamics_cartesian",
           "car_dynamics_curvilinear", "car_dynamics_rate_augmented",
           "race_car_ocp", "make_wave_track"]
