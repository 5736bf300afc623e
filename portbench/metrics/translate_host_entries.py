"""translate_host_entries: the dictionary entries the host worked through
to translate the probe columns into the build sides' codes (the
``host_entries`` count on the program's collected ``join:translate``
stages), per staged query.  A string probe counts its whole dictionary,
searched on the host at every query; a typed probe counts the build
dictionary, parsed once when its translation is not yet cached (0 on a
hit); a probe translated on the card counts 0.  The join cells' probes
are string columns.  A program that counts nothing there gives nothing
to read."""


def read(run):
    from csvplus_tpu_torch.utils.observe import telemetry

    got = [r.extra["host_entries"] for r in telemetry.records
           if r.stage == "join:translate" and "host_entries" in r.extra]
    return sum(got) / run.staged_units if got and run.staged_units else None
