"""Workload configurations of the update path: the port's own copies of
``repro.configs.go_kge`` and ``repro.configs.hp_kge``, with the same
values."""
