"""Layout: logical-axis sharding rules and per-device shapes."""
