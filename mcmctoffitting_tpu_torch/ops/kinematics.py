"""Two-body reaction kinematics and time of flight.

Port of ``mcmctoffitting_tpu/ops/kinematics.py``: ``tof`` and
``dd_neutron_energy`` on torch tensors (any shape, any device), and the f64
numpy twins used to build the host-side tables.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mcmctoffitting_tpu.constants import masses, physics, q_values


def dd_neutron_energy(deuteron_energy: torch.Tensor,
                      lab_angle_deg: float = 0.0) -> torch.Tensor:
    """Energy (keV) of neutrons from d(d,n)3He at a lab angle.

    En = (r + sqrt(r^2 + s))^2 with r = sqrt(m_d m_n E_d) cos(theta) /
    (m_n + m_He3) and s = (E_d (m_He3 - m_d) + Q m_He3) / (m_n + m_He3).
    """
    e_d = deuteron_energy
    theta = lab_angle_deg * math.pi / 180.0
    r = (torch.sqrt(masses.deuteron * masses.neutron * e_d)
         / (masses.neutron + masses.he3) * math.cos(theta))
    s = ((e_d * (masses.he3 - masses.deuteron) + q_values.ddn * masses.he3)
         / (masses.neutron + masses.he3))
    sqrt_en = r + torch.sqrt(r * r + s)
    return sqrt_en * sqrt_en


def dd_neutron_energy_np(deuteron_energy, lab_angle_deg: float = 0.0):
    """Host f64 numpy twin of :func:`dd_neutron_energy`."""
    e_d = np.asarray(deuteron_energy, dtype=np.float64)
    theta = lab_angle_deg * np.pi / 180.0
    r = (np.sqrt(masses.deuteron * masses.neutron * e_d)
         / (masses.neutron + masses.he3) * np.cos(theta))
    s = ((e_d * (masses.he3 - masses.deuteron) + q_values.ddn * masses.he3)
         / (masses.neutron + masses.he3))
    return (r + np.sqrt(r * r + s)) ** 2


def tof(mass: float, energy: torch.Tensor, distance) -> torch.Tensor:
    """Non-relativistic time of flight in ns (mass keV/c^2, energy keV,
    distance cm): v = c sqrt(2E/m), t = d/v."""
    velocity = physics.speed_of_light * torch.sqrt(2.0 * energy / mass)
    return distance / velocity


def tof_np(mass: float, energy, distance) -> np.ndarray:
    """Host numpy twin of :func:`tof`, in the dtype of ``energy`` and
    ``distance`` (constants rounded to it, as torch and JAX round a
    Python float)."""
    energy = np.asarray(energy)
    dt = np.result_type(energy, np.asarray(distance))
    velocity = dt.type(physics.speed_of_light) * np.sqrt(
        dt.type(2.0) * energy / dt.type(mass))
    return np.asarray(distance, dtype=dt) / velocity
