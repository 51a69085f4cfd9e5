"""plan_ms: per query, the benchmark's DebugTimer root around the query
call less the program's ``step:*`` spans inside it (parse, bind,
optimise, plan choice and the host work between steps), averaged over
the traced window's queries outside the profiled slice."""


def read(rec):
    xs = rec["plan_ms"]
    return sum(xs) / len(xs) if xs else None
