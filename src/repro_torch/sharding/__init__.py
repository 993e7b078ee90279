"""Sharding layer of the port: roles -> specs and DTensor placements
(`policies`), and the activation-sharding context (`context`)."""
