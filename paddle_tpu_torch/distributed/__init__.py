"""Distributed runtime services (counterpart of
``paddle_tpu/distributed``): the elastic dataset master (`master`), which
leases record-file chunk tasks to stateless trainers with timeouts, a
failure budget and snapshot/recover; the parameter server behind the
``listen_and_serv`` and ``send`` ops (`param_server`); and `backoff`."""
from .master import (Task, MasterService, MasterServer, MasterClient,  # noqa: F401
                     NoMoreTasks, AllTasksFailed)
from .backoff import Backoff  # noqa: F401
