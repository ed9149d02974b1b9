"""AWS Glue catalog under-database (a copy of ``alluxio_tpu/table/glue.py``).

Re-design of ``table/server/underdb/glue/src/main/java/alluxio/table/
under/glue/GlueDatabase.java:72`` (+ ``GlueUtils``): snapshot a Glue
database's tables/partitions into the journaled catalog. Differences
from the reference, on purpose:

* The Glue client is a ~100-line AWS JSON-1.1 REST client signed with
  the repo's own SigV4 signer (``underfs/s3.py``) instead of the AWS
  SDK — the protocol is one POST per operation with an
  ``X-Amz-Target: AWSGlue.<Op>`` header.
* Path translation rides the same ``PathTranslator`` as the Hive UDB
  (reference ``PathTranslator.java``) so table locations map onto the
  caching data plane via the mount table.

Attach options (reference ``Property.java:249-254`` names kept):
  aws.region       Glue region (required unless glue.endpoint set)
  aws.catalog.id   optional catalog id (cross-account catalogs)
  aws.accesskey    access key (defaults to env AWS_ACCESS_KEY_ID)
  aws.secretkey    secret key (defaults to env AWS_SECRET_ACCESS_KEY)
  glue.endpoint    endpoint override (fake servers / VPC endpoints)
  path_translations  "ufs1=/ns1,ufs2=/ns2" explicit overrides
"""

from __future__ import annotations

import hashlib
import json
import os
import urllib.error
import urllib.request
from typing import Dict, Iterator, List, Optional

from alluxio_tpu_torch.table.hive import PathTranslator, mount_translations
from alluxio_tpu_torch.table.udb import UdbTable, UnderDatabase
from alluxio_tpu_torch.utils.exceptions import NotFoundError, UnavailableError
from alluxio_tpu_torch.utils.httperr import error_body


class GlueClient:
    """Minimal AWS JSON-1.1 client for the five catalog-snapshot calls
    (reference: the AWSGlue SDK usage in ``GlueDatabase.java``)."""

    def __init__(self, *, region: str, access_key: str = "",
                 secret_key: str = "", endpoint: str = "",
                 catalog_id: str = "", timeout_s: float = 30.0) -> None:
        if not endpoint:
            if not region:
                raise ValueError("glue udb needs aws.region "
                                 "(or glue.endpoint)")
            endpoint = f"https://glue.{region}.amazonaws.com"
        self._endpoint = endpoint.rstrip("/")
        self._catalog_id = catalog_id
        self._timeout = timeout_s
        self._signer = None
        if access_key and secret_key:
            from alluxio_tpu_torch.underfs.s3 import SigV4Signer

            self._signer = SigV4Signer(access_key, secret_key,
                                       region or "us-east-1",
                                       service="glue")

    def _post(self, op: str, body: dict) -> dict:
        if self._catalog_id:
            body = {"CatalogId": self._catalog_id, **body}
        payload = json.dumps(body).encode()
        headers = {
            "Content-Type": "application/x-amz-json-1.1",
            "X-Amz-Target": f"AWSGlue.{op}",
        }
        if self._signer is not None:
            headers = self._signer.sign(
                "POST", self._endpoint + "/", headers,
                hashlib.sha256(payload).hexdigest())
        req = urllib.request.Request(self._endpoint + "/", data=payload,
                                     headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as r:
                return json.loads(r.read() or b"{}")
        except urllib.error.HTTPError as e:
            # parse-sensitive: Glue signals EntityNotFound as HTTP 400
            # with the type in the body — read it whole, truncate only
            # what goes into the message
            full = error_body(e, limit=1 << 20)
            detail = full[:400]
            try:
                err_type = json.loads(full).get("__type", "")
            except ValueError:
                err_type = ""
            if "EntityNotFoundException" in err_type or e.code == 404:
                raise NotFoundError(f"glue {op}: {detail}") from None
            raise UnavailableError(
                f"glue {op}: HTTP {e.code} {detail}") from None
        except OSError as e:
            raise UnavailableError(f"glue {op}: {e}") from None

    def _paged(self, op: str, body: dict, result_key: str) -> Iterator[dict]:
        token: Optional[str] = None
        while True:
            page = dict(body)
            if token:
                page["NextToken"] = token
            resp = self._post(op, page)
            yield from resp.get(result_key, [])
            token = resp.get("NextToken")
            if not token:
                return

    def get_database(self, name: str) -> dict:
        return self._post("GetDatabase", {"Name": name}).get("Database", {})

    def get_tables(self, db: str) -> List[dict]:
        return list(self._paged("GetTables", {"DatabaseName": db},
                                "TableList"))

    def get_table(self, db: str, name: str) -> dict:
        return self._post("GetTable", {"DatabaseName": db,
                                       "Name": name}).get("Table", {})

    def get_partitions(self, db: str, table: str) -> List[dict]:
        return list(self._paged(
            "GetPartitions", {"DatabaseName": db, "TableName": table},
            "Partitions"))


class GlueUnderDatabase(UnderDatabase):
    """``table attachdb glue <endpoint-or-region> <db> [-o k=v ...]``.

    The connection string is either a ``https://...`` endpoint override
    or a bare region name (``us-west-2``)."""

    udb_type = "glue"

    def __init__(self, fs, connection: str, db_name: str = "",
                 options: Optional[Dict[str, str]] = None) -> None:
        self._fs = fs
        self._name = db_name
        opts = options or {}
        endpoint = opts.get("glue.endpoint", "")
        region = opts.get("aws.region", "")
        if connection.startswith(("http://", "https://")):
            endpoint = endpoint or connection
        elif connection:
            region = region or connection
        self._client = GlueClient(
            region=region, endpoint=endpoint,
            catalog_id=opts.get("aws.catalog.id", ""),
            access_key=opts.get("aws.accesskey",
                                os.environ.get("AWS_ACCESS_KEY_ID", "")),
            secret_key=opts.get("aws.secretkey",
                                os.environ.get("AWS_SECRET_ACCESS_KEY", "")))
        mapping = mount_translations(fs)
        for pair in opts.get("path_translations", "").split(","):
            if "=" in pair:
                u, _, a = pair.partition("=")
                mapping[u.strip()] = a.strip()
        self._translator = PathTranslator(mapping)

    def database_name(self) -> str:
        if not self._name:
            raise NotFoundError("glue udb needs an explicit database "
                                "name (attachdb <type> <uri> <db>)")
        return self._name

    def _translate(self, location: str) -> str:
        t = self._translator.translate(location)
        return t if t is not None else location

    def table_names(self) -> List[str]:
        db = self.database_name()
        self._client.get_database(db)  # EntityNotFound -> NotFoundError
        return sorted(t.get("Name", "") for t in
                      self._client.get_tables(db))

    def get_table(self, name: str) -> UdbTable:
        db = self.database_name()
        t = self._client.get_table(db, name)
        if not t:
            raise NotFoundError(f"glue table {db}.{name} not found")
        sd = t.get("StorageDescriptor", {}) or {}
        schema = [{"name": c.get("Name", ""), "type": c.get("Type", "")}
                  for c in sd.get("Columns", [])]
        pkeys = [c.get("Name", "") for c in t.get("PartitionKeys", [])]
        location = self._translate(sd.get("Location", ""))
        rows = []
        if pkeys:
            rows = [(p.get("Values", []),
                     self._translate((p.get("StorageDescriptor", {})
                                      or {}).get("Location", "")))
                    for p in self._client.get_partitions(db, name)]
        return UdbTable.build(name, schema, location, pkeys, rows)
