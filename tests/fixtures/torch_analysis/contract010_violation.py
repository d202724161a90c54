"""Seeded CONTRACT010 violations: unregistered telemetry kinds at
``.log``/``.emit`` call sites."""


def typo_kind(tel, step, loss):
    tel.log("trian", step, loss=loss)                # VIOLATION CONTRACT010


def unregistered_kind(rec, step):
    rec.emit("heartbeat", step, ok=True)             # VIOLATION CONTRACT010


def forked_stream(writer, metrics):
    writer.log("serve_v2", 0,                        # VIOLATION CONTRACT010
               **metrics)
