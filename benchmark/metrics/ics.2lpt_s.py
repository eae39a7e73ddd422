"""ics.2lpt_s: seconds of the ICs' second-order stage, the program's span
`ics.2lpt` (a child of `ics`, models/ics.py): above 640^3 hires cells the
spectral truncation to 512^3, then the six phi_ij, the source's FFT and the
three gradients. The span closes on a device synchronisation, so on the card
it reads the stage's device time. Read from the process totals of the
program's recorder (`py21cmfast_torch.tracing.totals()`): the ICs run
outside any run, once in a run's set-up, and the value is a call's mean over
the calls booked. None for a record of no run that made its ICs (no
`ics_s`), where the program has no recorder or books no such span."""

UNIT = "s"
LAYER = "initial conditions"
MOVES = "setup_s"
SPAN = "ics.2lpt"


def read(record):
    if not record.get("ics_s"):  # not the record of a run that made its ICs
        return None
    try:
        from py21cmfast_torch import tracing
    except ImportError:
        return None
    booked = tracing.totals()["spans"].get(SPAN)
    return booked[1] / booked[0] if booked else None
