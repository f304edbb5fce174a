"""Meshes and the logical sharding rules of the port (`sharding`)."""
