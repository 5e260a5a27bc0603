"""Ladder layer: the share, in %, of the rungs' host seconds
(``profile=``, every step of the window) spent in the three QR rescue
rungs (free_qr, qr6, qr8)."""

QR = ("free_qr", "qr6", "qr8")


def read(run):
    prof = run.records.get("rung_profile")
    if not prof:
        return None
    total = sum(s for step in prof for _, _, s in step.values())
    qr = sum(step[k][2] for step in prof for k in QR if k in step)
    return 100.0 * qr / total if total > 0 else None
