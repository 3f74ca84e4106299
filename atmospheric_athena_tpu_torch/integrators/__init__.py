"""Time integrators (the CTU 3D hydro step)."""
