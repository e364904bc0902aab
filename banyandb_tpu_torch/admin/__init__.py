"""Operational subsystems: backup/restore, admission control, metrics
(the reference's banyand/backup, banyand/protector, pkg/meter +
banyand/observability analogs)."""
