"""Netlists, the CGP / PCC / NSGA-II phases and the circuit-accurate TNN."""
