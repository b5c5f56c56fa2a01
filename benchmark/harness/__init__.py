"""The benchmark's yardstick: cell lookup, generators, the served system's
load, the plain reference, the comparison, the roofline and the trace."""
