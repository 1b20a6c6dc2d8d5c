"""Multi-device layouts of the port: process groups and collectives
(``comm``), the (dp, sp, tp) mesh and the sharding specs (``mesh``)."""
